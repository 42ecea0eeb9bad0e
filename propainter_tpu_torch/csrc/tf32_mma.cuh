// Tensor-core and copy pieces shared by the 3xTF32 kernels: K4 and K5
// (through attention_tile.cuh), K3 (deform_conv.cu) and K1
// (corr_lookup_moenc.cu).
//
// 3xTF32. A product operand x is split as x = big + small, with big =
// tf32(x) rounded to nearest (the rounding of cvt.rna.tf32.f32) and small =
// x - big, exact in fp32, which the tensor core reads as TF32 by dropping
// its low 13 bits; a·b ~ big_a·big_b + big_a·small_b + small_a·big_b is
// summed by mma.sync.m16n8k8 (tf32 in, fp32 accumulators). The dropped
// small·small term and the truncation leave ~2^-21 of each product: fp32
// level, where one pass of TF32 (~2^-11) does not hold 1e-4 of the output
// scale.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, bit for bit on finite inputs, in
// two integer instructions; the cvt itself compiles to four on sm_90a
// (it also screens Inf and NaN, which pass through this unchanged).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small as mma operands: three instructions per value.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a · b for one m16n8k8 tile (a: rows g, g + 8 x k slots t, t + 4;
// b: k slots t, t + 4 x column g; d: rows g, g + 8 x columns 2t, 2t + 1;
// g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32 (a = a_big + a_small, b's fragment b0, b1 likewise):
// small·big, big·small, then big·big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     uint32_t b0_big, uint32_t b0_small,
                                     uint32_t b1_big, uint32_t b1_small) {
  mma(d, a_small, b0_big, b1_big);
  mma(d, a_big, b0_small, b1_small);
  mma(d, a_big, b0_big, b1_big);
}

// Element i of v (i a constant once the caller's loops are unrolled).
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes from src to dst, or 16 zero bytes when !live (nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

}  // namespace tc
