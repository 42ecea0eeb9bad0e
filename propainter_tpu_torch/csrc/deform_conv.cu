// K3: modulated deformable convolution (DCNv2), 3x3, stride/pad/dilation 1,
// and K6: the same bilinear sampling without the contraction.
//
// K3 replaces propainter_tpu/ops/deform_pallas.py:_kernel_out, K6
// propainter_tpu/ops/deform_pallas.py:_kernel. Semantics:
// propainter_tpu_torch/ops/deform.py:modulated_deform_conv2d and
// deform_sample. Both sample through bilinear_zero (zero-padded bilinear,
// each corner outside the image weighted 0).
//
// K3 layout (all fp32, contiguous): x (B, H, W, C); offset (B, H, W, dg, 9,
// 2) as (dy, dx); mask (B, H, W, dg, 9); weight (9, C, O) = HWIO; bias (O);
// out (B, H, W, O). O is 128 (both ProPainter call sites).
//
// K3 design: one block per 32 output positions (the caller's
// block_positions, the one size compiled), one thread per output channel.
// For each 64-channel slice the block samples the 9 taps of every position
// into shared memory (bilinear weight x modulation, zero outside the image;
// consecutive threads take consecutive channels of one pixel, so the reads
// of x are coalesced), then each thread contracts the 576 sampled rows with
// its weight column, accumulating one output per position in registers.
// The sampled tensor never reaches device memory. Bound: operations
// (2 * 9 * C * O FLOPs per position).
//
// K6 layout (fp32, contiguous): x (B, H, W, C); sy, sx, mask (B, Ho, Wo, dg,
// K) absolute sample coordinates and modulation; out (B, Ho, Wo, dg, K, Cg)
// with Cg = C / dg. K6 design: one thread per output value, consecutive
// threads on consecutive channels of one (position, group, tap), so the
// reads of x and the writes of out are coalesced. The TPU kernel builds a
// one-hot interpolation matrix per tap and contracts it on the MXU; here
// each value reads its four corners directly. Bound: bytes (the output, 9x
// the size of x, dominates).

#include <cuda_runtime.h>

namespace {

constexpr int kO = 128;         // output channels = threads
constexpr int kCC = 64;         // channels per slice
constexpr int kRows = 9 * kCC;  // sampled rows per slice
constexpr int kSampleThreads = 256;

// Bilinear sample at (sy, sx) of the channel whose value at pixel (0, 0) is
// xc[0] (pixels C floats apart); a corner outside [0, H-1] x [0, W-1] adds 0.
__device__ __forceinline__ float bilinear_zero(const float* __restrict__ xc,
                                               int H, int W, int C, float sy,
                                               float sx) {
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float fy = sy - y0, fx = sx - x0;
  float s = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float yy = y0 + dy, xx = x0 + dx;
      if (yy >= 0.f && yy <= H - 1 && xx >= 0.f && xx <= W - 1) {
        const float wgt = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
        s += wgt * __ldg(xc + (static_cast<size_t>(yy) * W
                               + static_cast<size_t>(xx)) * C);
      }
    }
  }
  return s;
}

template <int kPT>              // output positions per block
constexpr size_t smem_bytes() { return sizeof(float) * kRows * (kPT + 1); }

template <int kPT>
__global__ void __launch_bounds__(kO)
deform_conv_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int B, int H, int W, int C, int dg) {
  constexpr int kLd = kPT + 1;     // padded row: conflict-free writes
  extern __shared__ float samp[];  // [kRows][kLd]
  const int tid = threadIdx.x;
  const int n_pos = B * H * W;
  const int p0 = blockIdx.x * kPT;
  const int cg = C / dg;

  float acc[kPT];
#pragma unroll
  for (int q = 0; q < kPT; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    for (int e = tid; e < kRows * kPT; e += kO) {
      const int cc = e % kCC;
      const int q = (e / kCC) % kPT;
      const int k = e / (kCC * kPT);
      const int p = p0 + q;
      float v = 0.f;
      if (p < n_pos) {
        const int b = p / (H * W);
        const int hw = p - b * H * W;
        const int h = hw / W, w = hw - (hw / W) * W;
        const int c = c0 + cc;
        const size_t om = (static_cast<size_t>(p) * dg + c / cg) * 9 + k;
        const float sy = static_cast<float>(h + k / 3 - 1) + offset[2 * om];
        const float sx = static_cast<float>(w + k % 3 - 1) + offset[2 * om + 1];
        const float* xb = x + static_cast<size_t>(b) * H * W * C + c;
        v = bilinear_zero(xb, H, W, C, sy, sx) * mask[om];
      }
      samp[(k * kCC + cc) * kLd + q] = v;
    }
    __syncthreads();
    for (int k = 0; k < 9; ++k) {
      const float* wk = weight + (static_cast<size_t>(k) * C + c0) * kO + tid;
      for (int cc = 0; cc < kCC; ++cc) {
        const float wv = __ldg(wk + static_cast<size_t>(cc) * kO);
        const float* row = samp + (k * kCC + cc) * kLd;
#pragma unroll
        for (int q = 0; q < kPT; ++q) acc[q] += row[q] * wv;
      }
    }
    __syncthreads();
  }

  const float bv = bias[tid];
#pragma unroll
  for (int q = 0; q < kPT; ++q) {
    const int p = p0 + q;
    if (p < n_pos) out[static_cast<size_t>(p) * kO + tid] = acc[q] + bv;
  }
}

template <int kPT>
int launch(const void* x, const void* offset, const void* mask,
           const void* weight, const void* bias, void* out, int B, int H,
           int W, int C, int dg, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        deform_conv_kernel<kPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<kPT>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int n_pos = B * H * W;
  const int blocks = (n_pos + kPT - 1) / kPT;
  deform_conv_kernel<kPT><<<blocks, kO, smem_bytes<kPT>(), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C,
      dg);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kSampleThreads)
deform_sample_kernel(const float* __restrict__ x, const float* __restrict__ sy,
                     const float* __restrict__ sx,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int H, int W, int C, int HWo, int dg, int K,
                     long long n_out) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kSampleThreads + threadIdx.x;
  if (e >= n_out) return;
  const int cg_n = C / dg;
  const long long om = e / cg_n;            // (b, ho, wo, g, k)
  const int c = static_cast<int>((om / K) % dg) * cg_n
                + static_cast<int>(e % cg_n);
  const long long b = om / (static_cast<long long>(K) * dg * HWo);
  const float* xc = x + b * H * W * C + c;
  out[e] = bilinear_zero(xc, H, W, C, sy[om], sx[om]) * mask[om];
}

}  // namespace

extern "C" int deform_sample(const void* x, const void* sy, const void* sx,
                             const void* mask, void* out, int B, int H, int W,
                             int C, int Ho, int Wo, int dg, int K,
                             void* stream) {
  if (dg < 1 || C % dg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_out = static_cast<long long>(B) * Ho * Wo * K * C;
  const long long blocks = (n_out + kSampleThreads - 1) / kSampleThreads;
  deform_sample_kernel<<<static_cast<unsigned>(blocks), kSampleThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const float*>(mask),
      static_cast<float*>(out), H, W, C, Ho * Wo, dg, K, n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modulated_deform_conv2d(const void* x, const void* offset,
                                       const void* mask, const void* weight,
                                       const void* bias, void* out, int B,
                                       int H, int W, int C, int dg,
                                       int block_positions, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_positions != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch<32>(x, offset, mask, weight, bias, out, B, H, W, C, dg, s);
}
