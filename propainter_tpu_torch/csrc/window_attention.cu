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
// q, k, v and out bf16 in the layouts above, the bias fp32. Q·Kᵀ is one
// m16n8k16 bf16 pass with fp32 accumulators (bf16_mma.cuh): the products of
// bf16 values are exact in fp32, so this is the TPU kernel's upcast fp32
// product up to summation order. Logits, running max and sum are fp32
// (log2 units, as the fp32 form); the probabilities are rounded to bf16
// for the P·V pass (one bf16 pass), and the output is rounded to bf16.
// The TPU kernel normalises p before it rounds it; this streamed softmax
// rounds the running, unnormalised p and divides at the end, a
// difference of a bf16 step. A first, simple design beside the fp32 tile
// (which is unchanged): one block of 4 warps per (problem, 64-query tile),
// Q fragments in registers, K/V streamed in 32-key tiles through a 2-slot
// cp.async ring, V's B fragments by ldmatrix.trans. Bound: operations (4 *
// Tq * Tk * 128 FLOPs per problem at the bf16 tensor-core rate).

#include <cuda_bf16.h>

#include "attention_tile.cuh"
#include "bf16_mma.cuh"

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

constexpr int kBKb = 32;            // keys per streamed tile
constexpr int kLdb = kD + 8;        // bf16 per K/V row: 68 words = 4 mod 32
constexpr int kTileB = kBKb * kLdb; // bf16 per K (or V) tile

__global__ void __launch_bounds__(kThreads)
window_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ o, int G, int Tq,
                             int Tk, float scale) {
  // [slot][K tile, V tile]
  __shared__ __align__(16) __nv_bfloat16 ring[2][2 * kTileB];
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kn = k + static_cast<size_t>(n) * Tk * kD;
  const __nv_bfloat16* vn = v + static_cast<size_t>(n) * Tk * kD;
  const float* bn =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(n / G) * Tk;
  const int n_tiles = (Tk + kBKb - 1) / kBKb;

  auto issue = [&](int tile, int slot) {
    __nv_bfloat16* ks = ring[slot];
    __nv_bfloat16* vs = ring[slot] + kTileB;
#pragma unroll
    for (int i = 0; i < kBKb * kD / 8 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int c = e / (kD / 8), col = 8 * (e % (kD / 8));
      const int key = tile * kBKb + c;
      const bool live = key < Tk;
      const size_t off = live ? static_cast<size_t>(key) * kD + col : 0;
      bf::cp_async16(ks + c * kLdb + col, kn + off, live);
      bf::cp_async16(vs + c * kLdb + col, vn + off, live);
    }
  };
  issue(0, 0);
  bf::cp_async_commit();

  // this warp's 16 query rows as A fragments (zeros past Tq)
  const int row0 = q0 + 16 * warp + g;
  uint32_t qa[kD / 16][4];
  {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(
        q + static_cast<size_t>(n) * Tq * kD);
#pragma unroll
    for (int p = 0; p < kD / 16; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1);
        const int d = 16 * p + 2 * t + 8 * (e >> 1);
        qa[p][e] = row < Tq ? __ldg(qw + (static_cast<size_t>(row) * kD + d) / 2)
                            : 0u;
      }
  }
  const float qscale = scale * kLog2e;
  float acc[kD / 8][4];
#pragma unroll
  for (int nn = 0; nn < kD / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1, (j + 1) & 1);
    bf::cp_async_commit();
    bf::cp_async_wait<1>();
    __syncthreads();   // tile j landed
    const __nv_bfloat16* ks = ring[j & 1];
    const __nv_bfloat16* vs = ring[j & 1] + kTileB;
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(ks);

    // S = Q·Kᵀ over the tile's 4 n-tiles of 8 keys
    float s[kBKb / 8][4];
#pragma unroll
    for (int jn = 0; jn < kBKb / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
      const int kb = (8 * jn + g) * (kLdb / 2) + t;
#pragma unroll
      for (int p = 0; p < kD / 16; ++p)
        bf::mma(s[jn], qa[p], kw[kb + 8 * p], kw[kb + 8 * p + 4]);
    }
    // logits (log2 units), masks, running max, probabilities
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int jn = 0; jn < kBKb / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kBKb + 8 * jn + 2 * t + (e & 1);
        float& x = s[jn][e];
        x = key >= Tk ? -CUDART_INF_F
                      : x * qscale + (bn == nullptr ? 0.f : bn[key] * kLog2e);
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(mt[i]));
      alpha[i] = m_run[i] == -CUDART_INF_F ? 0.f
                                           : exp2_approx(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int jn = 0; jn < kBKb / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[jn][e];
        x = x == -CUDART_INF_F ? 0.f : exp2_approx(x - m_run[e >> 1]);
        l_run[e >> 1] += x;
      }
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }
    // O += bf16(P)·V: k-step ks16 over keys 16 ks16 .. + 15 takes the
    // probabilities of n-tiles 2 ks16 and 2 ks16 + 1
#pragma unroll
    for (int ks16 = 0; ks16 < kBKb / 16; ++ks16) {
      const uint32_t pa[4] = {
          bf::pack(s[2 * ks16][0], s[2 * ks16][1]),
          bf::pack(s[2 * ks16][2], s[2 * ks16][3]),
          bf::pack(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1]),
          bf::pack(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3])};
      const int key = 16 * ks16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int u = 0; u < kD / 16; ++u) {
        uint32_t b[4];
        bf::ldmatrix_x4_trans(b, vs + key * kLdb + 16 * u + 8 * (lane >> 4));
        bf::mma(acc[2 * u], pa, b[0], b[1]);
        bf::mma(acc[2 * u + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp done with slot j & 1
  }
  bf::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / quad_sum(l_run[i]);
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(n) * Tq + row) * kD + 2 * t;
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nn) =
          __floats2bfloat162_rn(acc[nn][2 * i] * inv,
                                acc[nn][2 * i + 1] * inv);
  }
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

// The bf16 form: q, k, v, out bf16; bias fp32 or null.
extern "C" int window_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int n_problems, int G, int Tq,
                                     int Tk, float scale, void* stream) {
  const dim3 grid((Tq + kBQ - 1) / kBQ, n_problems);
  window_attention_bf16_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), G, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the bf16 form (static shared memory, one block per
// query tile).
extern "C" int window_attention_bf16_launch_info(void* info, void*) {
  int* i = static_cast<int*>(info);
  i[1] = 0;
  i[2] = kThreads;
  i[3] = kBQ;
  i[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      i, window_attention_bf16_kernel, kThreads, 0));
}
