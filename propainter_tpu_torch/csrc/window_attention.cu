// K4: attention with a per-key additive bias, fp32 in and out.
//
// Replaces propainter_tpu/ops/flash_attention.py:_kernel. Semantics:
// propainter_tpu_torch/ops/flash_attention.py:flash_window_attention.
//
// Layout (fp32, contiguous): q (N, Tq, 128); k, v (N, Tk, 128); bias
// (N / G, Tk) shared by the G problems of a batch row, or null; out like q.
//
// Design: a problem's K/V (2380 x 128 at 432x240, 1.2 MB each) does not fit
// in shared memory, so the TPU kernel's whole-K/V-resident softmax does not
// carry over. One block of 4 warps per (problem, 64-query tile) streams K/V
// in 32-key tiles through the 3xTF32 tensor-core online softmax of
// attention_tile.cuh (cp.async ring, two blocks per SM). Keys at or past
// Tk are excluded (probability 0); the bias is added per key. (Splitting a
// query tile's keys over a cluster of two blocks, as K5 does, measured no
// faster here: PERF.md, §6.)
// Bound: operations, 3 x 4 * Tq * Tk * 128 FLOPs per problem on the
// tensor cores in TF32.

#include "attention_tile.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias, float* __restrict__ o,
                        int G, int Tq, int Tk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem);
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, Tq - q0);
  const int t = threadIdx.x % 4;
  const float* kn = k + static_cast<size_t>(n) * Tk * kD;
  const float* vn = v + static_cast<size_t>(n) * Tk * kD;
  const float* bn = bias == nullptr ? nullptr
                                    : bias + static_cast<size_t>(n / G) * Tk;

  load_queries(sm, q + (static_cast<size_t>(n) * Tq + q0) * kD, n_rows,
                scale * kLog2e);
  Running run;
  init(run);
  stream(
      sm, 0, (Tk + kBK - 1) / kBK, kn, [](int, int) {},
      [&](int tile, int, int c, const float*& kr, const float*& vr) {
        const int key = tile * kBK + c;
        if (key >= Tk) return false;
        kr = kn + static_cast<size_t>(key) * kD;
        vr = vn + static_cast<size_t>(key) * kD;
        return true;
      },
      [&](int tile, int stage) {
        if (!warp_live(n_rows)) return;
        float kb[kNT][2];
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = tile * kBK + 8 * jn + 2 * t + e;
            kb[jn][e] = key >= Tk ? -CUDART_INF_F
                                  : (bn == nullptr ? 0.f : bn[key] * kLog2e);
          }
        softmax_step(sm, stage, run, kb,
                     [](int, int, int) { return true; });
      });
  store(o + (static_cast<size_t>(n) * Tq + q0) * kD, n_rows, run);
}

bool configured[kMaxDevices] = {};   // per device (attention_tile.cuh)

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

// Launch facts for chip_smoke.py's build phase (attention_tile.cuh:
// launch_info).
extern "C" int window_attention_launch_info(void* info, void*) {
  return launch_info(window_attention_kernel, configured, 1,
                     static_cast<int*>(info));
}
