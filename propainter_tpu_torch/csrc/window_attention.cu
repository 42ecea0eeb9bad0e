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
// streams K/V in 64-key tiles through the online softmax of
// attention_tile.cuh. Keys at or past Tk are excluded (probability 0); the
// bias is added per key. Bound: operations (4 * Tq * Tk * 128 fp32 FLOPs
// per problem on CUDA cores).

#include "attention_tile.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias, float* __restrict__ o,
                        int G, int Tq, int Tk, float scale) {
  extern __shared__ float smem[];
  const Smem sm = carve(smem);
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, Tq - q0);
  const int tx = threadIdx.x % 16;
  const float* kn = k + static_cast<size_t>(n) * Tk * kD;
  const float* vn = v + static_cast<size_t>(n) * Tk * kD;
  const float* bn = bias == nullptr ? nullptr
                                    : bias + static_cast<size_t>(n / G) * Tk;

  load_queries(sm, q + (static_cast<size_t>(n) * Tq + q0) * kD, n_rows);
  Running run;
  init(run);
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps consumed
    load_keys(sm, [&](int c, const float*& kr, const float*& vr) {
      if (k0 + c >= Tk) return false;
      kr = kn + static_cast<size_t>(k0 + c) * kD;
      vr = vn + static_cast<size_t>(k0 + c) * kD;
      return true;
    });
    __syncthreads();
    float kb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      kb[j] = key >= Tk ? -CUDART_INF_F : (bn == nullptr ? 0.f : bn[key]);
    }
    softmax_step(sm, run, scale, kb, [](int, int) { return true; });
  }
  store(o + (static_cast<size_t>(n) * Tq + q0) * kD, n_rows, run);
}

bool configured = false;

}  // namespace

extern "C" int window_attention(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int n_problems,
                                int G, int Tq, int Tk, float scale,
                                void* stream) {
  const int err = configure(window_attention_kernel, configured);
  if (err != 0) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, n_problems);
  window_attention_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), G, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
