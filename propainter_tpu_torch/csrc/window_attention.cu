// K4: attention with a per-key additive bias, fp32 logits and softmax.
//
// Replaces propainter_tpu/ops/flash_attention.py:_kernel. Semantics:
// propainter_tpu_torch/ops/flash_attention.py:flash_window_attention.
//
// Layout (fp32, contiguous): q (N, Tq, 128); k, v (N, Tk, 128); bias
// (N / G, Tk) shared by the G problems of a batch row, or null; out like q.
//
// Design: a problem's K/V (2380 x 128 at 432x240, 1.2 MB each) does not fit
// in shared memory, so the TPU kernel's whole-K/V-resident softmax does not
// carry over. One block of 256 threads per (problem, 128-query tile)
// streams K/V in 64-key tiles with an fp32 online softmax (running max and
// sum per row, output rescaled when the max grows). Each thread owns an
// 8 x 4 block of logits and an 8 x 8 block of the output. Keys at or past
// Tk are excluded (probability 0); the bias is added per key. The (Tq, Tk)
// logits never reach device memory. Bound: operations (4 * Tq * Tk * 128 fp32
// FLOPs per problem on CUDA cores).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kD = 128;
constexpr int kBQ = 128;   // queries per block
constexpr int kBK = 64;    // keys per streamed tile
constexpr int kRows = 8;   // query rows per thread
constexpr int kThreads = 256;
constexpr int kLdQ = kBQ + 4;   // padded leading dims of the
constexpr int kLdK = kBK + 4;   // transposed tiles
constexpr size_t kSmemFloats =
    kD * kLdQ          // Qs[d][query]
    + kD * kLdK        // Ks[d][key]
    + kBK * kD         // Vs[key][d]
    + kBK * kLdQ;      // Ps[key][query]
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias, float* __restrict__ o,
                        int G, int Tq, int Tk, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kD * kLdQ;
  float* Vs = Ks + kD * kLdK;
  float* Ps = Vs + kBK * kD;

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*8.., keys tx*4..
  const float* qn = q + static_cast<size_t>(n) * Tq * kD;
  const float* kn = k + static_cast<size_t>(n) * Tk * kD;
  const float* vn = v + static_cast<size_t>(n) * Tk * kD;
  const float* bn = bias == nullptr ? nullptr
                                    : bias + static_cast<size_t>(n / G) * Tk;

  for (int e = tid; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    Qs[d * kLdQ + r] = (q0 + r < Tq) ? qn[static_cast<size_t>(q0 + r) * kD + d]
                                     : 0.f;
  }

  float acc[kRows][8];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps consumed
    for (int e = tid; e < kBK * kD; e += kThreads) {
      const int c = e / kD, d = e % kD;
      const bool live = k0 + c < Tk;
      const size_t g = static_cast<size_t>(k0 + c) * kD + d;
      Ks[d * kLdK + c] = live ? kn[g] : 0.f;
      Vs[c * kD + d] = live ? vn[g] : 0.f;
    }
    __syncthreads();

    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < kD; ++d) {
      float av[8];
      load8(Qs + d * kLdQ + ty * kRows, av);
      const float4 b = *reinterpret_cast<const float4*>(Ks + d * kLdK + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      const float kb = key >= Tk ? -CUDART_INF_F
                                 : (bn == nullptr ? 0.f : bn[key]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[i][j] = key >= Tk ? -CUDART_INF_F : s[i][j] * scale + kb;
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m_run[i], mt);
      const float alpha =
          m_run[i] == -CUDART_INF_F ? 0.f : expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        Ps[(tx * 4 + j) * kLdQ + ty * kRows + i] = s[i][j];
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[8], vv[8];
      load8(Ps + c * kLdQ + ty * kRows, pv);
      load8(Vs + c * kD + tx * 8, vv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= Tq) continue;
    const float inv = 1.f / l_run[i];
    float* orow = o + (static_cast<size_t>(n) * Tq + r) * kD + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[j] = acc[i][j] * inv;
  }
}

}  // namespace

extern "C" int window_attention(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int n_problems,
                                int G, int Tq, int Tk, float scale,
                                void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Tq + kBQ - 1) / kBQ, n_problems);
  window_attention_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), G, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
