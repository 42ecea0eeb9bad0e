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
//
// The bf16 form (window_attention_bf16; the TPU kernel as the JAX bf16
// pipeline runs it). Semantics:
// propainter_tpu_torch/ops/flash_attention.py:flash_window_attention_bf16.
// q, k, v and out bf16 in the layouts above, the bias fp32. The kernel
// runs on the wgmma tile of attention_wgmma.cuh: one block of a producer
// and two consumer warpgroups per (problem, 128-query tile). The producer
// brings Q, K and V in by TMA through 3-D tensor maps (N, T, 128), so a
// ragged tile never straddles two problems and rows past Tq or Tk arrive
// as zeros; the maps are encoded on the host for each call and passed as
// __grid_constant__ parameters; 128-key tiles in 2 stages, each tile's
// key biases staged by the producer warp in shared memory. Q·Kᵀ is one
// bf16 pass with fp32 sums: the products of bf16 values are exact in
// fp32, so this is the TPU kernel's upcast fp32 product up to summation
// order. Logits, running max and sum
// are fp32 (log2 units); the probabilities are rounded to bf16 for the
// P·V pass (one bf16 pass), and the output is rounded to bf16. The TPU
// kernel normalises p before it rounds it; this streamed softmax rounds
// the running, unnormalised p and divides at the end, a difference of a
// bf16 step. Bound: operations (4 * Tq * Tk * 128 FLOPs per problem at
// the bf16 tensor-core rate).

#include <cuda_bf16.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

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

// ---- the bf16 form --------------------------------------------------------

// the wgmma tile with key tiles of 128 keys
using Tile = wga::Ring<128>;

__global__ void __launch_bounds__(wga::kThreads, 1)
window_attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ o, int G, int Tq,
                             int Tk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // each ring stage's key biases, written by the producer before it
  // issues the stage's K (read before the K slot is released)
  __shared__ float key_bias[Tile::kStages][Tile::kBN];
  const Tile sm = wga::carve<Tile::kBN>(smem_raw);
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * wga::kBQ;
  const int n_tiles = (Tk + Tile::kBN - 1) / Tile::kBN;
  wga::init_barriers(sm, 1);
  __syncthreads();

  const int group = wga::warpgroup();
  const int lane = threadIdx.x % 32;
  if (group == 0) {
    // producer: warp 0 writes each tile's key biases (log2 units, -inf
    // past Tk) into the table beside the ring; lane 0 issues every copy
    wga::producer_regs();
    if (threadIdx.x >= 32) return;
    const float* bn =
        bias == nullptr ? nullptr : bias + static_cast<size_t>(n / G) * Tk;
    if (lane == 0) {
      wga::bar_expect(sm.q_full(), wga::kQBytes);
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wga::tma_load_3d(sm.q() + a * wga::kQAtom, &q_map, sm.q_full(),
                         64 * a, q0, n);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % Tile::kStages;
      const int parity = ((j / Tile::kStages) & 1) ^ 1;   // slot freed
      float b[Tile::kBN / 32];
#pragma unroll
      for (int h = 0; h < Tile::kBN / 32; ++h) {
        const int key = j * Tile::kBN + 32 * h + lane;
        b[h] = key >= Tk        ? -CUDART_INF_F
               : bn == nullptr ? 0.f
                               : __ldg(bn + key) * wga::kLog2e;
      }
      wga::bar_wait(sm.k_empty(st), parity);
#pragma unroll
      for (int h = 0; h < Tile::kBN / 32; ++h)
        key_bias[st][32 * h + lane] = b[h];
      __syncwarp();
      if (lane == 0) {
        wga::bar_expect(sm.k_full(st), Tile::kTileBytes);
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wga::tma_load_3d(sm.k(st) + a * Tile::kTileAtom, &k_map,
                           sm.k_full(st), 64 * a, j * Tile::kBN, n);
        wga::bar_wait(sm.v_empty(st), parity);
        wga::bar_expect(sm.v_full(st), Tile::kTileBytes);
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wga::tma_load_3d(sm.v(st) + a * Tile::kTileAtom, &v_map,
                           sm.v_full(st), 64 * a, j * Tile::kBN, n);
      }
      __syncwarp();
    }
  } else {
    wga::consumer_regs();
    const int c = group - 1;
    const int t = lane % 4;
    wga::Rows r;
    wga::bar_wait(sm.q_full(), 0);
    wga::consume<Tile::kBN, false, false>(
        sm, c, n_tiles, scale * wga::kLog2e,
        [&](int tile, float (&kb)[Tile::kBlocks][2]) {
          const float* tb = key_bias[tile % Tile::kStages];
#pragma unroll
          for (int j = 0; j < Tile::kBlocks; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) kb[j][e] = tb[8 * j + 2 * t + e];
        },
        [](int, int, int, int) { return true; }, r);
    wga::store(o + (static_cast<size_t>(n) * Tq + q0) * wga::kD, c,
               Tq - q0, r);
  }
}

bool configured_bf16[wga::kMaxDevices] = {};

int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                const void* v, int n_problems, int Tq, int Tk) {
  int err = wga::encode(&maps[0], q, n_problems, Tq, wga::kBQ);
  if (err == 0) err = wga::encode(&maps[1], k, n_problems, Tk, Tile::kBN);
  if (err == 0) err = wga::encode(&maps[2], v, n_problems, Tk, Tile::kBN);
  return err;
}

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

// The bf16 form: q, k, v, out bf16 (16-byte aligned); bias fp32 or null.
extern "C" int window_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int n_problems, int G, int Tq,
                                     int Tk, float scale, void* stream) {
  int err =
      wga::configure<Tile::kBN>(window_attention_bf16_kernel, configured_bf16);
  if (err != 0) return err;
  CUtensorMap maps[3];
  err = encode_maps(maps, q, k, v, n_problems, Tq, Tk);
  if (err != 0) return err;
  const dim3 grid((Tq + wga::kBQ - 1) / wga::kBQ, n_problems);
  window_attention_bf16_kernel<<<grid, wga::kThreads, Tile::kSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), G, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the bf16 form (attention_wgmma.cuh: launch_info).
extern "C" int window_attention_bf16_launch_info(void* info, void*) {
  return wga::launch_info<Tile::kBN>(window_attention_bf16_kernel,
                                     configured_bf16,
                                     static_cast<int*>(info));
}

// Encodes the three tensor maps of one call `reps` times (no launch), for
// timing the host's share of a call.
extern "C" int window_attention_bf16_encode(const void* q, const void* k,
                                            const void* v, int n_problems,
                                            int Tq, int Tk, int reps,
                                            void*) {
  CUtensorMap maps[3];
  for (int i = 0; i < reps; ++i) {
    const int err = encode_maps(maps, q, k, v, n_problems, Tq, Tk);
    if (err != 0) return err;
  }
  return 0;
}
