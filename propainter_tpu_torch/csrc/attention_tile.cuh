// The streamed-softmax tile shared by K4 (window_attention.cu) and K5
// (sparse_window_attention.cu): fp32 logits and softmax, head width 128.
//
// One block of kThreads threads holds kBQ queries, transposed, in shared
// memory and streams keys through it kBK at a time with an online softmax
// (running max and sum per query row; the output is rescaled when the max
// grows). Each thread owns an 8 x 4 block of a tile's logits and an 8 x 8
// block of the output. The (queries, keys) logits never reach device
// memory. A key or a (query, key) pair that is masked gets probability 0
// exactly (never exp of a large negative number), so a row whose keys are
// all masked so far carries nothing forward.
//
// A kernel calls, per block: load_queries; then per key tile
// __syncthreads, load_keys, __syncthreads, softmax_step; then store.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace attn {

constexpr int kD = 128;     // head width
constexpr int kBQ = 128;    // queries per block
constexpr int kBK = 64;     // keys per streamed tile
constexpr int kRows = 8;    // query rows per thread
constexpr int kThreads = 256;
constexpr int kLdQ = kBQ + 4;   // padded leading dims of the
constexpr int kLdK = kBK + 4;   // transposed tiles
constexpr size_t kSmemFloats =
    kD * kLdQ          // Qs[d][query]
    + kD * kLdK        // Ks[d][key]
    + kBK * kD         // Vs[key][d]
    + kBK * kLdQ;      // Ps[key][query]
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

struct Smem {
  float* Qs;
  float* Ks;
  float* Vs;
  float* Ps;
};

__device__ __forceinline__ Smem carve(float* smem) {
  Smem s;
  s.Qs = smem;
  s.Ks = s.Qs + kD * kLdQ;
  s.Vs = s.Ks + kD * kLdK;
  s.Ps = s.Vs + kBK * kD;
  return s;
}

// One thread's rows of the running softmax.
struct Running {
  float acc[kRows][8];
  float m[kRows];
  float l[kRows];
};

__device__ __forceinline__ void init(Running& r) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    r.m[i] = -CUDART_INF_F;
    r.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.acc[i][j] = 0.f;
  }
}

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

// Qs[d][r] = q[r * kD + d] for the n_rows rows from q; zeros past them.
__device__ __forceinline__ void load_queries(const Smem& s, const float* q,
                                             int n_rows) {
  for (int e = threadIdx.x; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    s.Qs[d * kLdQ + r] = r < n_rows ? q[static_cast<size_t>(r) * kD + d] : 0.f;
  }
}

// Key tile: rows(c, k_row, v_row) says whether tile key c is live and, if
// so, sets the rows of K and V it reads; dead keys load as zeros. The rows
// are read with __ldg: a row pointer a kernel keeps in shared memory is
// otherwise a generic pointer that may alias the tile stores, and the
// loads are then issued one at a time.
template <class KeyRows>
__device__ __forceinline__ void load_keys(const Smem& s, KeyRows rows) {
  for (int e = threadIdx.x; e < kBK * kD; e += kThreads) {
    const int c = e / kD, d = e % kD;
    const float* kr = nullptr;
    const float* vr = nullptr;
    const bool live = rows(c, kr, vr);
    s.Ks[d * kLdK + c] = live ? __ldg(kr + d) : 0.f;
    s.Vs[c * kD + d] = live ? __ldg(vr + d) : 0.f;
  }
}

// One key tile through the running softmax. key_bias[j] is the additive
// logit bias of the thread's key tx*4 + j (-inf: masked for every row);
// visible(i, j) masks the pair (thread row ty*8 + i, key tx*4 + j).
template <class Visible>
__device__ __forceinline__ void softmax_step(const Smem& sm, Running& r,
                                             float scale,
                                             const float (&key_bias)[4],
                                             Visible visible) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < kD; ++d) {
    float av[8];
    load8(sm.Qs + d * kLdQ + ty * kRows, av);
    const float4 b = *reinterpret_cast<const float4*>(sm.Ks + d * kLdK + tx * 4);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = visible(i, j) ? s[i][j] * scale + key_bias[j] : -CUDART_INF_F;
    float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    mt = half_warp_max(mt);
    const float m_new = fmaxf(r.m[i], mt);
    const float alpha = r.m[i] == -CUDART_INF_F ? 0.f : expf(r.m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
      s[i][j] = p;
      rs += p;
    }
    rs = half_warp_sum(rs);
    r.l[i] = r.l[i] * alpha + rs;
    r.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.acc[i][j] *= alpha;
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      sm.Ps[(tx * 4 + j) * kLdQ + ty * kRows + i] = s[i][j];
  __syncthreads();

  for (int c = 0; c < kBK; ++c) {
    float pv[8], vv[8];
    load8(sm.Ps + c * kLdQ + ty * kRows, pv);
    load8(sm.Vs + c * kD + tx * 8, vv);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) r.acc[i][j] += pv[i] * vv[j];
  }
}

// o[r * kD + ...] = acc / l for the n_rows rows from o.
__device__ __forceinline__ void store(float* o, int n_rows, const Running& r) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * kRows + i;
    if (row >= n_rows) continue;
    const float inv = 1.f / r.l[i];
    float* orow = o + static_cast<size_t>(row) * kD + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[j] = r.acc[i][j] * inv;
  }
}

// Launch configuration every kernel built on the tile needs once: more
// than 48 KB of dynamic shared memory.
template <class Kernel>
__host__ int configure(Kernel kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

}  // namespace attn
