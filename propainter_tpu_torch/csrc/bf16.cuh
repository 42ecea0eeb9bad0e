// bf16 rounding and packing shared by the bf16 forms of K1 and K3
// (corr_lookup_moenc.cu, deform_conv.cu), and the commit and wait of their
// cp.async copies.
//
// The kernels round exactly where the TPU kernels round: a value is
// rounded to bf16 (to nearest even) and carried on in fp32. A product of
// two bf16 values is exact in fp32, so a tensor-core pass over bf16
// operands with fp32 accumulators differs from an fp32 matrix product of
// the same values only in summation order: the TPU kernels' bf16 x bf16
// -> fp32 contraction.

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

}  // namespace bf
