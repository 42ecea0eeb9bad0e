// K1: RAFT radius-4 correlation lookup fused with the motion encoder's
// convc1 (1x1 conv 324 -> 256) and relu.
//
// Replaces propainter_tpu/ops/corr_pallas.py:_lookup_kernel (moenc
// epilogue). Semantics: propainter_tpu_torch/ops/corr.py:corr_lookup_moenc.
//
// Layout: level l of the pyramid is (N, H_l, W_l) fp32, row n = query n's
// correlation with every key pixel; coords (N, 2) pixel (x, y); weight
// (324, 256) row-major with row c = l*81 + i*9 + j (window sample at
// (x + i - 4, y + j - 4) / 2^l); out (N, 256).
//
// Design: one block per 32 queries, one thread per output channel.
// Phase 1 fills shared memory with the 32 x 324 window values (each a
// bilinear mix of four integer neighbours of the query's own map, zero
// outside). Phase 2 multiplies them by the weight, staged in shared memory
// in 36-row tiles, accumulating 32 outputs per thread in registers. The
// (N, 324) window tensor never reaches device memory. Bound: operations
// (2 * 324 * 256 fp32 FLOPs per query on CUDA cores).

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 4;
constexpr int kTaps = 2 * kRadius + 1;          // 9
constexpr int kLevels = 4;
constexpr int kC = kLevels * kTaps * kTaps;     // 324
constexpr int kF = 256;                          // convc1 outputs
constexpr int kQT = 32;                          // queries per block
constexpr int kCT = 36;                          // weight rows per tile
constexpr int kThreads = kF;
constexpr size_t kSmemBytes = sizeof(float) * (kC * kQT + kCT * kF);
static_assert(kC % kCT == 0, "weight tiles must cover 324 rows");

struct Levels {
  const float* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

__device__ __forceinline__ float tap(const float* m, int H, int W, float y,
                                     float x) {
  if (x < 0.f || x > W - 1 || y < 0.f || y > H - 1) return 0.f;
  return __ldg(m + static_cast<int>(y) * W + static_cast<int>(x));
}

__global__ void __launch_bounds__(kThreads)
corr_lookup_moenc_kernel(Levels lv, const float* __restrict__ coords,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int n_query) {
  extern __shared__ float smem[];
  float* corr_s = smem;               // [kC][kQT]
  float* w_s = smem + kC * kQT;       // [kCT][kF]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT;

  for (int e = tid; e < kC * kQT; e += kThreads) {
    const int q = e % kQT;
    const int c = e / kQT;
    const int n = q0 + q;
    float val = 0.f;
    if (n < n_query) {
      const int l = c / (kTaps * kTaps);
      const int i = (c / kTaps) % kTaps;   // x offset (major)
      const int j = c % kTaps;             // y offset
      const float scale = 1.f / static_cast<float>(1 << l);
      const float x = coords[2 * n] * scale;
      const float y = coords[2 * n + 1] * scale;
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      const int H = lv.h[l], W = lv.w[l];
      const float* m = lv.ptr[l] + static_cast<size_t>(n) * H * W;
      const float xa = x0 + static_cast<float>(i - kRadius);
      const float ya = y0 + static_cast<float>(j - kRadius);
      const float left = tap(m, H, W, ya, xa) * (1.f - fy)
                         + tap(m, H, W, ya + 1.f, xa) * fy;
      const float right = tap(m, H, W, ya, xa + 1.f) * (1.f - fy)
                          + tap(m, H, W, ya + 1.f, xa + 1.f) * fy;
      val = left * (1.f - fx) + right * fx;
    }
    corr_s[c * kQT + q] = val;
  }

  float acc[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < kC; c0 += kCT) {
    __syncthreads();  // corr_s complete / previous weight tile consumed
    for (int e = tid; e < kCT * kF; e += kThreads)
      w_s[e] = __ldg(weight + static_cast<size_t>(c0) * kF + e);
    __syncthreads();
    for (int cc = 0; cc < kCT; ++cc) {
      const float wv = w_s[cc * kF + tid];
      const float4* row =
          reinterpret_cast<const float4*>(corr_s + (c0 + cc) * kQT);
#pragma unroll
      for (int q4 = 0; q4 < kQT / 4; ++q4) {
        const float4 v = row[q4];
        acc[4 * q4 + 0] += v.x * wv;
        acc[4 * q4 + 1] += v.y * wv;
        acc[4 * q4 + 2] += v.z * wv;
        acc[4 * q4 + 3] += v.w * wv;
      }
    }
  }

  const float b = bias[tid];
#pragma unroll
  for (int q = 0; q < kQT; ++q) {
    const int n = q0 + q;
    if (n < n_query)
      out[static_cast<size_t>(n) * kF + tid] = fmaxf(acc[q] + b, 0.f);
  }
}

}  // namespace

extern "C" int corr_lookup_moenc(const void* l0, const void* l1,
                                 const void* l2, const void* l3,
                                 const void* coords, const void* weight,
                                 const void* bias, void* out, int n_query,
                                 int h0, int w0, int h1, int w1, int h2,
                                 int w2, int h3, int w3, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        corr_lookup_moenc_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Levels lv;
  lv.ptr[0] = static_cast<const float*>(l0);
  lv.ptr[1] = static_cast<const float*>(l1);
  lv.ptr[2] = static_cast<const float*>(l2);
  lv.ptr[3] = static_cast<const float*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int blocks = (n_query + kQT - 1) / kQT;
  corr_lookup_moenc_kernel<<<blocks, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(out), n_query);
  return static_cast<int>(cudaGetLastError());
}
