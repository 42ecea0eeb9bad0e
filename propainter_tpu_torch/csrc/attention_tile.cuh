// The streamed-softmax tile shared by K4 (window_attention.cu) and K5
// (sparse_window_attention.cu): fp32 inputs and outputs, head width 128,
// both products on the tensor cores in 3xTF32.
//
// Numerics. Both products run in 3xTF32 (tf32_mma.cuh): each operand
// split big + small, three mma.sync.m16n8k8 per product. The running max,
// sum and exponentials are fp32; logits are kept in log2 units (the
// queries are prescaled by scale · log2 e, biases by log2 e) so the
// exponentials are ex2.approx, a few ulp. A masked key or (query, key)
// pair gets probability 0 exactly, never the exp of a large negative
// number, so a row whose keys are all masked so far carries nothing
// forward.
//
// Work split (FlashAttention-2). A block of kWarps warps holds kBQ = 16 *
// kWarps query rows; warp w owns rows 16w .. 16w + 15 for the whole key
// stream. Thread (g, t) = (lane / 4, lane % 4) of the warp holds rows g and
// g + 8, so a row's max and sum live in the 4 threads of an mma quad. The
// logits never leave registers: the logit accumulator of an 8-key n-tile is,
// element for element, the A fragment of the P·V k-step over those keys
// once its k slots t and t + 4 stand for keys 2t and 2t + 1. The Q·Kᵀ
// k-steps number the head dimension the same way (slots t, t + 4 of k-step
// 2p are d = 16p + 4t, +1; of k-step 2p + 1, d + 2, d + 3), so one 128-bit
// load gives a thread its Q or K values of two k-steps.
//
// Where the split happens. Shared memory holds the fp32 values only, and
// each warp splits the fragments it loads, in registers. Splitting once in
// shared memory (big and small copies of Q and of each K/V tile) needs
// twice the room and a third pass over every tile: at 205 KB one block
// filled an SM, the split pass and its barrier stalled all four warps, and
// K4 took 2.35 ms on an H100 (PERF.md, §6). Here a block takes 105 KB,
// two blocks share an SM, and the splits are ALU work beside the mma.
//
// Shared memory, in carve() order (floats):
//   Q    [kBQ][kLdQK]             the queries (prescaled), loaded once
//   ring [kStages] x (K [kBK][kLdQK], V [kBK][kLdV])  filled by cp.async
// kLdQK = 16 (mod 32) makes the 128-bit Q and K fragment loads free of bank
// conflicts, kLdV = 4 (mod 32) the 32-bit V loads.
//
// Pipeline (stream()): per key tile j, wait for its copies, one barrier
// (tile j visible; every warp done with tile j - 1's slot), start tile
// j + kStages - 1's copies into that slot, compute tile j.
//
// Split-K over a cluster (split_range(), finish_split(); K5's dirty
// windows). A query tile's key tiles are shared by a cluster of kSplit = 2
// blocks, each streaming half; block 1 then writes its part of the running
// softmax (o unnormalized, row max and sum) into block 0's shared memory,
// and block 0 merges the two and writes the rows. Halving the blocks'
// length halves the last wave's idle tail: at the main path's occupancy K5
// has 336 dirty query tiles for 264 resident blocks, two rounds of whole
// blocks; as 672 half blocks they take three rounds of half blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace attn {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::mma;
using tc::mma3;
using tc::split;

constexpr int kD = 128;             // head width
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;    // queries per block
constexpr int kBK = 32;             // keys per streamed tile
constexpr int kNT = kBK / 8;        // 8-key n-tiles per key tile
constexpr int kStages = 2;          // ring slots
constexpr int kBlocksPerSm = 2;     // resident blocks the kernels ask for
constexpr int kSplit = 2;           // blocks (a cluster) per query tile
constexpr int kLdQK = kD + 16;
constexpr int kLdV = kD + 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSlotFloats = kBK * kLdQK + kBK * kLdV;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kLdQK + kStages * kSlotFloats);
static_assert(kStages * kSlotFloats >= kBQ * (kD + 2),
              "block 0's ring receives block 1's part");

struct Smem {
  float* Q;
  float* ring;
};

__device__ __forceinline__ Smem carve(float* smem) {
  return Smem{smem, smem + kBQ * kLdQK};
}

__device__ __forceinline__ float* slot_k(const Smem& s, int stage) {
  return s.ring + stage * kSlotFloats;
}

__device__ __forceinline__ float* slot_v(const Smem& s, int stage) {
  return slot_k(s, stage) + kBK * kLdQK;
}

// ---- softmax pieces ------------------------------------------------------

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the block's tiles -----------------------------------------------------

// Q[r] = q[r * kD ...] * qscale for the n_rows rows from q; zeros past them.
__device__ __forceinline__ void load_queries(const Smem& s,
                                             const float* __restrict__ q,
                                             int n_rows, float qscale) {
  for (int e = threadIdx.x; e < kBQ * kD / 4; e += kThreads) {
    const int r = e / (kD / 4), c = 4 * (e % (kD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows)
      x = __ldg(reinterpret_cast<const float4*>(
          q + static_cast<size_t>(r) * kD + c));
    *reinterpret_cast<float4*>(s.Q + r * kLdQK + c) = make_float4(
        x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
  }
}

// Starts the copies of one key tile into ring slot `stage`:
// rows(c, kr, vr) says whether tile key c is live and, if so, sets the K
// and V rows it reads; a dead key's rows are zero-filled from `fallback`
// (a valid address that is not read). One warp copies one 512-byte row.
template <class Rows>
__device__ __forceinline__ void issue_keys(const Smem& s, int stage,
                                           const float* fallback, Rows rows) {
  float* ks = slot_k(s, stage);
  float* vs = slot_v(s, stage);
#pragma unroll
  for (int i = 0; i < kBK * kD / 4 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int c = e / (kD / 4), col = 4 * (e % (kD / 4));
    const float* kr = fallback;
    const float* vr = fallback;
    const bool live = rows(c, kr, vr);
    cp_async16(ks + c * kLdQK + col, live ? kr + col : fallback, live);
    cp_async16(vs + c * kLdV + col, live ? vr + col : fallback, live);
  }
}

// ---- one warp's rows of the running softmax -------------------------------

struct Running {
  float o[kD / 8][4];   // n-tile n: rows g, g + 8 x columns 8n + 2t, +1
  float m[2];           // rows g, g + 8: running max (log2 units)
  float l[2];           // this thread's part of the running sum
};

__device__ __forceinline__ void init(Running& r) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r.m[i] = -CUDART_INF_F;
    r.l[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) r.o[n][j] = 0.f;
}

// True when the warp owns a query row below n_rows (a warp past them
// skips the products and the store, but not the block's loads and
// barriers).
__device__ __forceinline__ bool warp_live(int n_rows) {
  return 16 * (static_cast<int>(threadIdx.x) / 32) < n_rows;
}

// One key tile (ring slot `stage`) through the warp's running softmax.
// bias[jn][e] is the additive logit bias (log2 units) of the tile's key
// 8 jn + 2t + e, -inf when that key is masked for every row;
// visible(i, jn, e) masks the pair (row g + 8 i, that key).
template <class Visible>
__device__ __forceinline__ void softmax_step(const Smem& sm, int stage,
                                             Running& r,
                                             const float (&bias)[kNT][2],
                                             Visible visible) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = 16 * (threadIdx.x / 32) + g;

  // S = Q·Kᵀ: big·big into sb, the two cross terms into sx (two
  // accumulator chains per n-tile)
  float sb[kNT][4], sx[kNT][4];
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
    for (int j = 0; j < 4; ++j) sb[jn][j] = sx[jn][j] = 0.f;
  const float* qp = sm.Q + row * kLdQK + 4 * t;
  const float* kp = slot_k(sm, stage) + g * kLdQK + 4 * t;
#pragma unroll
  for (int p = 0; p < kD / 16; ++p) {
    // rows g and g + 8 of the queries, d = 16p + 4t .. + 3
    const float4 q0 = *reinterpret_cast<const float4*>(qp + 16 * p);
    const float4 q1 =
        *reinterpret_cast<const float4*>(qp + 8 * kLdQK + 16 * p);
    const float qa[2][4] = {{q0.x, q1.x, q0.y, q1.y},
                            {q0.z, q1.z, q0.w, q1.w}};
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) split(qa[h][j], a_big[h][j], a_small[h][j]);
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) {
      // key g of n-tile jn, the same four d
      const float4 kv =
          *reinterpret_cast<const float4*>(kp + 8 * jn * kLdQK + 16 * p);
      const float kf[4] = {kv.x, kv.y, kv.z, kv.w};
      uint32_t b_big[4], b_small[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split(kf[j], b_big[j], b_small[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma(sb[jn], a_big[h], b_big[2 * h], b_big[2 * h + 1]);
        mma(sx[jn], a_big[h], b_small[2 * h], b_small[2 * h + 1]);
        mma(sx[jn], a_small[h], b_big[2 * h], b_big[2 * h + 1]);
      }
    }
  }

  // masks, running max, probabilities (in place of the logits)
  float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& s = sb[jn][2 * i + e];
        s = visible(i, jn, e) ? s + sx[jn][2 * i + e] + bias[jn][e]
                              : -CUDART_INF_F;
        mt[i] = fmaxf(mt[i], s);
      }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(r.m[i], quad_max(mt[i]));
    alpha[i] = r.m[i] == -CUDART_INF_F ? 0.f : exp2_approx(r.m[i] - m_new);
    r.m[i] = m_new;
    r.l[i] *= alpha[i];
  }
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& s = sb[jn][2 * i + e];
        s = s == -CUDART_INF_F ? 0.f : exp2_approx(s - r.m[i]);
        r.l[i] += s;
      }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    r.o[n][0] *= alpha[0];
    r.o[n][1] *= alpha[0];
    r.o[n][2] *= alpha[1];
    r.o[n][3] *= alpha[1];
  }

  // O += P·V: the k-step over keys 8 jn .. 8 jn + 7 takes its A fragment
  // from the probabilities of n-tile jn (slots t, t + 4: keys 2t, 2t + 1)
  const float* vp = slot_v(sm, stage) + 2 * t * kLdV + g;
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn) {
    const float pa[4] = {sb[jn][0], sb[jn][2], sb[jn][1], sb[jn][3]};
    uint32_t a_big[4], a_small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(pa[j], a_big[j], a_small[j]);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      // keys 8 jn + 2t and + 1, column 8n + g
      const float* v0 = vp + 8 * jn * kLdV + 8 * n;
      uint32_t b0_big, b0_small, b1_big, b1_small;
      split(v0[0], b0_big, b0_small);
      split(v0[kLdV], b1_big, b1_small);
      mma3(r.o[n], a_big, a_small, b0_big, b0_small, b1_big, b1_small);
    }
  }
}

// Streams key tiles first .. first + n_tiles - 1 through the block's
// running softmax.
// prepare(tile, slot): bookkeeping a kernel needs before tile `tile`'s
// copies start (K5's key table for that tile, in table slot `slot`); it
// runs a whole tile ahead, between one tile's copies and its neighbour's
// products, so its latency hides behind them. rows(tile, slot, c, kr, vr):
// the K and V rows of the tile's key c (false: a dead key). step(tile,
// stage): the tile's softmax step on ring slot `stage`.
template <class Prepare, class Rows, class Step>
__device__ __forceinline__ void stream(const Smem& sm, int first,
                                       int n_tiles, const float* fallback,
                                       Prepare prepare, Rows rows,
                                       Step step) {
  // local index i: tile first + i, ring and table slot i % kStages
  auto issue = [&](int i) {
    const int slot = i % kStages;
    issue_keys(sm, slot, fallback, [&](int c, const float*& kr,
                                       const float*& vr) {
      return rows(first + i, slot, c, kr, vr);
    });
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    if (st < n_tiles) prepare(first + st, st);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) issue(st);
    cp_async_commit();
  }
  if (kStages - 1 < n_tiles) prepare(first + kStages - 1, kStages - 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int next = j + kStages - 1;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j landed; tile j - 1's slot consumed
    if (next < n_tiles) issue(next);
    cp_async_commit();
    if (next + 1 < n_tiles)
      prepare(first + next + 1, (next + 1) % kStages);
    step(first + j, j % kStages);
  }
}

// The key tiles [first, first + count) that this block of its cluster
// streams, of n_tiles.
__device__ __forceinline__ void split_range(int n_tiles, int& first,
                                            int& count) {
  const int h = static_cast<int>(
      cooperative_groups::this_cluster().block_rank());
  first = n_tiles * h / kSplit;
  count = n_tiles * (h + 1) / kSplit - first;
}

// o[r * kD + ...] = o / l for the warp's rows below n_rows.
__device__ __forceinline__ void store(float* o, int n_rows, Running& r) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = 16 * (threadIdx.x / 32) + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / quad_sum(r.l[i]);
    if (row + 8 * i >= n_rows) continue;
    float* orow = o + static_cast<size_t>(row + 8 * i) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(r.o[n][2 * i] * inv, r.o[n][2 * i + 1] * inv);
  }
}

// The end of a split-K block pair (see the top): both blocks call it after
// streaming their halves; block 0 writes the merged rows below n_rows.
__device__ __forceinline__ void finish_split(const Smem& sm, float* o,
                                             int n_rows, Running& r) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = 16 * (threadIdx.x / 32) + g;
  const float l[2] = {quad_sum(r.l[0]), quad_sum(r.l[1])};
  float* part = sm.ring;            // [kBQ][kD] o, then [kBQ][2] (m, l)
  cluster.sync();                   // both blocks done with their rings
  if (cluster.block_rank() == 1) {
    float* remote = cluster.map_shared_rank(part, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = row + 8 * i;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        *reinterpret_cast<float2*>(remote + rr * kD + 8 * n + 2 * t) =
            make_float2(r.o[n][2 * i], r.o[n][2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(remote + kBQ * kD + 2 * rr) =
            make_float2(r.m[i], l[i]);
    }
  }
  cluster.sync();                   // block 1's part landed in block 0
  if (cluster.block_rank() != 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = row + 8 * i;
    const float2 ml = *reinterpret_cast<const float2*>(part + kBQ * kD +
                                                       2 * rr);
    const float m = fmaxf(r.m[i], ml.x);
    const float a0 = r.m[i] == -CUDART_INF_F ? 0.f : exp2_approx(r.m[i] - m);
    const float a1 = ml.x == -CUDART_INF_F ? 0.f : exp2_approx(ml.x - m);
    const float inv = 1.f / (l[i] * a0 + ml.y * a1);
    if (rr >= n_rows) continue;
    float* orow = o + static_cast<size_t>(rr) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float2 p =
          *reinterpret_cast<const float2*>(part + rr * kD + 8 * n + 2 * t);
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2((r.o[n][2 * i] * a0 + p.x * a1) * inv,
                      (r.o[n][2 * i + 1] * a0 + p.y * a1) * inv);
    }
  }
}

// Launch configuration every kernel built on the tile needs once per
// device: more than 48 KB of dynamic shared memory, an attribute of the
// kernel on one device. `configured` holds a flag per device; the setup is
// done for the device current at the call (the wrapper makes the tensors'
// device current).
constexpr int kMaxDevices = 64;

template <class Kernel>
__host__ int configure(Kernel kernel, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (configured[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured[dev] = true;
  return 0;
}

// info = {resident blocks per SM, dynamic shared memory bytes, threads
// per block, query rows per block, blocks per query tile} of a kernel
// built on the tile.
template <class Kernel>
__host__ int launch_info(Kernel kernel, bool (&configured)[kMaxDevices],
                         int split, int* info) {
  const int err = configure(kernel, configured);
  if (err != 0) return err;
  info[1] = static_cast<int>(kSmemBytes);
  info[2] = kThreads;
  info[3] = kBQ;
  info[4] = split;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info, kernel, kThreads, kSmemBytes));
}

}  // namespace attn
