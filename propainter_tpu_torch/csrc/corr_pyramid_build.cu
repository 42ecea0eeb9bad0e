// K2: RAFT correlation pyramid levels 1-3 from the level-0 volume.
//
// Replaces propainter_tpu/ops/corr_pallas.py:_flatten_copy_kernel and the
// 2x2 average pools around it (corr_pyramid_t). The level-0 volume
// fmap1 . fmap2^T / sqrt(D) comes from a batched GEMM outside the kernel.
// Semantics: propainter_tpu_torch/ops/corr.py:corr_pyramid_build.
//
// Layout: level l is (N, H_l, W_l) fp32 with H_{l+1} = floor(H_l / 2) (as
// F.avg_pool2d), row n = one query's map — the layout K1 reads.
//
// Design: one block per query row. Level 1 is pooled from level 0 in
// device memory, levels 2 and 3 from the previous level kept in shared
// memory, so level 0 is read once and each level written once. Bound:
// bytes (level 0 dominates: N * H * W * 4).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void pool_level(const float* src, int sw,
                                           float* dst_s, float* dst_g,
                                           int dh, int dw) {
  for (int e = threadIdx.x; e < dh * dw; e += kThreads) {
    const int y = e / dw, x = e % dw;
    const float* p = src + (2 * y) * sw + 2 * x;
    const float v = (p[0] + p[1] + p[sw] + p[sw + 1]) * 0.25f;
    if (dst_s != nullptr) dst_s[e] = v;
    dst_g[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
corr_pyramid_build_kernel(const float* __restrict__ l0, float* __restrict__ l1,
                          float* __restrict__ l2, float* __restrict__ l3,
                          int h0, int w0) {
  extern __shared__ float smem[];
  const int h1 = h0 / 2, w1 = w0 / 2;
  const int h2 = h1 / 2, w2 = w1 / 2;
  const int h3 = h2 / 2, w3 = w2 / 2;
  float* s1 = smem;
  float* s2 = smem + h1 * w1;
  const size_t n = blockIdx.x;
  pool_level(l0 + n * h0 * w0, w0, s1, l1 + n * h1 * w1, h1, w1);
  __syncthreads();
  pool_level(s1, w1, s2, l2 + n * h2 * w2, h2, w2);
  __syncthreads();
  pool_level(s2, w2, nullptr, l3 + n * h3 * w3, h3, w3);
}

}  // namespace

extern "C" int corr_pyramid_build(const void* l0, void* l1, void* l2,
                                  void* l3, int n, int h0, int w0,
                                  void* stream) {
  const int h1 = h0 / 2, w1 = w0 / 2;
  const size_t smem = sizeof(float) * (h1 * w1 + (h1 / 2) * (w1 / 2));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  corr_pyramid_build_kernel<<<n, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l0), static_cast<float*>(l1),
      static_cast<float*>(l2), static_cast<float*>(l3), h0, w0);
  return static_cast<int>(cudaGetLastError());
}
