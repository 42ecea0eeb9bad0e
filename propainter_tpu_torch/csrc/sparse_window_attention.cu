// K5: mask-guided sparse window attention, fp32 in and out.
//
// Replaces propainter_tpu/ops/attention.py:_kernel. Semantics:
// propainter_tpu_torch/ops/attention.py:sparse_window_attention.
//
// Layout (contiguous; ch = 128): q, k, v windows (BH, nW, T, win, ch);
// rolled k, v (BH, nW, 4, T, win, ch); pooled k, v (BH, T, P, ch), all
// fp32; roll_valid (4 * win) uint8; occupancy (B * nW) int32; frame_select
// (B, T) int32; out like q. BH = B * n_head with the head minor, so batch
// row b = bh / n_head owns the occupancy and frame selection.
//
// Design: the TPU kernel runs one program per (batch*head, window) — 64 at
// 432x240, under half of the card's 132 SMs — each looping over all frames.
// Here a cluster of two blocks per (batch*head, window, 64-query tile) of
// the window's T * win query rows (14 tiles of 855 rows) streams 32-key
// tiles through the 3xTF32 tensor-core online softmax of attention_tile.cuh
// (shared with K4). Each cluster reads its window's occupancy and takes its
// branch:
//   dirty (occupancy > 0): one softmax over, for each selected frame, the
//     window's win keys, the valid keys of the rolled band and the P
//     pooled keys — a flat list of n_sel * (win + n_valid + P) keys, half
//     of its tiles per block, merged as in K4. Two warps build the
//     selected-frame and valid-rolled lists with ballots; warp 0 then
//     writes each tile's 32-bit key rows into a table a tile ahead of its
//     copies, so the loads never wait on it. The TPU kernel instead masks
//     unselected frames and invalid
//     rolled keys with -1e9 and starts its running max at -1e9; their
//     weights then vanish at the first live frame (exp(-1e9 - m) = 0), so
//     skipping them is exactly equal. With no selected frame at all the
//     TPU kernel's every logit is -1e9, every key gets weight 1, and its
//     output is the plain mean of v over all T frames' win + 4 * win + P
//     keys, invalid rolled keys included; this kernel writes that mean.
//     (The pipeline never asks for it: the local frames are always
//     selected.)
//   clean: each query attends its own frame's win keys; block 0 of the
//     cluster streams the contiguous keys of the frames its rows span (at
//     most 3 at win = 45) and masks the pairs of other frames on the mma
//     fragment; block 1 has nothing to do.
// Bound: operations — dirty windows 4 * (T * win) * keys * 128 FLOPs per
// (batch*head), clean ones T * 4 * win^2 * 128, three times over on the
// tensor cores in TF32; the rolled copies (112 MB each at 432x240) are read
// once per query tile.
//
// The bf16 form (sparse_window_attention_bf16; the TPU kernel on the bf16
// windows of the JAX bf16 pipeline, which upcasts q, k and v to fp32 and
// writes its output in bf16, attention.py:51, 62-68, 98-99, 197).
// Semantics: propainter_tpu_torch/ops/attention.py:
// sparse_window_attention_bf16. q, k, v, rolled and pooled windows and
// the output bf16; roll_valid, occupancy and frame_select as above. The
// same kernel on attention_tile.cuh's bf16 tile: the rows come through the
// same cp.async ring at half the bytes, K and V are exact in TF32, so each
// product takes two passes in place of three (the bound's operations
// term: 2 x the product FLOPs at the TF32 rate); every sum, the softmax
// and the final division are fp32, and the output is rounded once.

#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int kMaxT = 64;          // frames
constexpr int kMaxWin = 64;        // tokens per window
constexpr int kMaxRolled = 4 * kMaxWin;
// key table entries: source << kSrcShift | row (from the source's base)
constexpr int kSrcShift = 28;
constexpr int kRowMask = (1 << kSrcShift) - 1;

// Appends the indices i < n with on(i) to list, in order, with one warp's
// ballots; returns the count (every lane).
template <class On, class Entry>
__device__ __forceinline__ int warp_compact(int n, On on, Entry entry,
                                            int* list) {
  const int lane = threadIdx.x % 32;
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool keep = i < n && on(i);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) list[count + __popc(ballot & ((1u << lane) - 1u))] = entry(i);
    count += __popc(ballot);
  }
  return count;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* o, float x) { *o = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

// The kernel's body for elements of type E (float or __nv_bfloat16); the
// two kernels below instantiate it.
template <class E>
__device__ __forceinline__ void sparse_window_attention_body(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ rk,
    const E* __restrict__ rv, const E* __restrict__ pk,
    const E* __restrict__ pv, const unsigned char* __restrict__ roll_valid,
    const int* __restrict__ occupancy, const int* __restrict__ frame_select,
    E* __restrict__ o, int n_head, int nW, int T, int win, int P,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sel[kMaxT];
  __shared__ int rolled[kMaxRolled];   // rolled rows of frame 0
  __shared__ int key_row[kStages][kBK];
  __shared__ int n_sel_s, n_rolled_s;
  const TileSmem<E> sm = carve<E>(smem);

  const int bh = blockIdx.z, w = blockIdx.y;
  const int b = bh / n_head;
  const int q0 = blockIdx.x / kSplit * kBQ;
  const bool dirty = occupancy[b * nW + w] > 0;
  const int h = static_cast<int>(
      cooperative_groups::this_cluster().block_rank());
  const int n_rows = min(kBQ, T * win - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t win_base = (static_cast<size_t>(bh) * nW + w) * T * win * kD;
  const E* kw = k + win_base;
  const E* vw = v + win_base;
  const E* rkw = rk + 4 * win_base;
  const E* rvw = rv + 4 * win_base;
  const size_t pool_base = static_cast<size_t>(bh) * T * P * kD;
  const E* pkw = pk + pool_base;
  const E* pvw = pv + pool_base;
  E* ow = o + win_base + static_cast<size_t>(q0) * kD;

  load_queries(sm, q + win_base + static_cast<size_t>(q0) * kD, n_rows,
                scale * kLog2e);
  Running run;
  init(run);

  if (dirty) {
    if (warp == 0) {
      const int n = warp_compact(
          T, [&](int i) { return frame_select[b * T + i] > 0; },
          [](int i) { return i; }, sel);
      if (lane == 0) n_sel_s = n;
    } else if (warp == 1) {
      const int n = warp_compact(
          4 * win, [&](int i) { return roll_valid[i] != 0; },
          [&](int i) { return (i / win) * T * win + i % win; }, rolled);
      if (lane == 0) n_rolled_s = n;
    }
    __syncthreads();
    const int n_sel = n_sel_s, n_valid = n_rolled_s;
    if (n_sel == 0) {
      if (h != 0) return;
      // every key of every frame with weight 1 (see the note above)
      const int n_keys = T * (5 * win + P);
      for (int d = tid; d < kD; d += kThreads) {
        float s = 0.f;
        for (int r = 0; r < T * win; ++r)
          s += to_float(vw[static_cast<size_t>(r) * kD + d]);
        for (int r = 0; r < 4 * T * win; ++r)
          s += to_float(rvw[static_cast<size_t>(r) * kD + d]);
        for (int r = 0; r < T * P; ++r)
          s += to_float(pvw[static_cast<size_t>(r) * kD + d]);
        const float mean = s / static_cast<float>(n_keys);
        for (int r = 0; r < n_rows; ++r)
          store1(ow + static_cast<size_t>(r) * kD + d, mean);
      }
      return;
    }
    const int per_frame = win + n_valid + P;
    const int n_keys = n_sel * per_frame;
    int first, n_tiles;
    split_range((n_keys + kBK - 1) / kBK, first, n_tiles);
    stream(
        sm, first, n_tiles, kw,
        [&](int tile, int slot) {
          if (warp != 0) return;
          for (int c = lane; c < kBK; c += 32) {
            const int key = tile * kBK + c;
            int entry = -1;
            if (key < n_keys) {
              const int f = key / per_frame, r = key - f * per_frame;
              const int t = sel[f];
              if (r < win)
                entry = t * win + r;
              else if (r < win + n_valid)
                entry = (1 << kSrcShift) | (rolled[r - win] + t * win);
              else
                entry = (2 << kSrcShift) | (t * P + r - win - n_valid);
            }
            key_row[slot][c] = entry;
          }
        },
        [&](int, int slot, int c, const E*& kr, const E*& vr) {
          const int entry = key_row[slot][c];
          if (entry < 0) return false;
          const int src = entry >> kSrcShift;
          const size_t off = static_cast<size_t>(entry & kRowMask) * kD;
          kr = (src == 0 ? kw : src == 1 ? rkw : pkw) + off;
          vr = (src == 0 ? vw : src == 1 ? rvw : pvw) + off;
          return true;
        },
        [&](int tile, int stage) {
          if (!warp_live(n_rows)) return;
          float kb[kNT][2];
#pragma unroll
          for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              kb[jn][e] = tile * kBK + 8 * jn + 2 * t4 + e < n_keys
                              ? 0.f : -CUDART_INF_F;
          softmax_step(sm, stage, run, kb,
                       [](int, int, int) { return true; });
        });
    finish_split(sm, ow, n_rows, run);
  } else {
    // block h takes warps 2h, 2h + 1 (rows 32h .. 32h + 31) and the
    // contiguous keys of their frames f0 .. f1, pairs across frames masked
    const int r0 = kBQ / kSplit * h;
    const int r1 = min(n_rows, r0 + kBQ / kSplit);
    if (r0 >= r1) return;
    const int f0 = (q0 + r0) / win, f1 = (q0 + r1 - 1) / win;
    const int key0 = f0 * win, n_keys = (f1 - f0 + 1) * win;
    const int row = q0 + 16 * warp + g;
    const int row_frame[2] = {row / win, (row + 8) / win};
    stream(
        sm, 0, (n_keys + kBK - 1) / kBK, kw, [](int, int) {},
        [&](int tile, int, int c, const E*& kr, const E*& vr) {
          const int key = tile * kBK + c;
          if (key >= n_keys) return false;
          const size_t off = static_cast<size_t>(key0 + key) * kD;
          kr = kw + off;
          vr = vw + off;
          return true;
        },
        [&](int tile, int stage) {
          if (warp / (kWarps / kSplit) != h || !warp_live(n_rows)) return;
          float kb[kNT][2];
          int key_frame[kNT][2];
#pragma unroll
          for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = tile * kBK + 8 * jn + 2 * t4 + e;
              kb[jn][e] = key < n_keys ? 0.f : -CUDART_INF_F;
              key_frame[jn][e] = (key0 + key) / win;
            }
          softmax_step(sm, stage, run, kb, [&](int i, int jn, int e) {
            return key_frame[jn][e] == row_frame[i];
          });
        });
    if (warp / (kWarps / kSplit) == h) store(ow, n_rows, run);
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kThreads, kBlocksPerSm)
    sparse_window_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ rk,
    const float* __restrict__ rv, const float* __restrict__ pk,
    const float* __restrict__ pv, const unsigned char* __restrict__ roll_valid,
    const int* __restrict__ occupancy, const int* __restrict__ frame_select,
    float* __restrict__ o, int n_head, int nW, int T, int win, int P,
    float scale) {
  sparse_window_attention_body(q, k, v, rk, rv, pk, pv, roll_valid,
                               occupancy, frame_select, o, n_head, nW, T,
                               win, P, scale);
}

__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kThreads, kBlocksPerSm)
    sparse_window_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ rk,
    const __nv_bfloat16* __restrict__ rv,
    const __nv_bfloat16* __restrict__ pk,
    const __nv_bfloat16* __restrict__ pv,
    const unsigned char* __restrict__ roll_valid,
    const int* __restrict__ occupancy, const int* __restrict__ frame_select,
    __nv_bfloat16* __restrict__ o, int n_head, int nW, int T, int win, int P,
    float scale) {
  sparse_window_attention_body(q, k, v, rk, rv, pk, pv, roll_valid,
                               occupancy, frame_select, o, n_head, nW, T,
                               win, P, scale);
}

// per device (attention_tile.cuh), one flag array per kernel
bool configured[kMaxDevices] = {};
bool configured_bf16[kMaxDevices] = {};

template <class E, class Kernel>
int launch(Kernel kernel, bool (&flags)[kMaxDevices], const void* q,
           const void* k, const void* v, const void* rk, const void* rv,
           const void* pk, const void* pv, const void* roll_valid,
           const void* occupancy, const void* frame_select, void* out,
           int BH, int n_head, int nW, int T, int win, int P, float scale,
           void* stream) {
  if (T > kMaxT || win > kMaxWin || win < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = configure<E>(kernel, flags);
  if (err != 0) return err;
  const dim3 grid((T * win + kBQ - 1) / kBQ * kSplit, nW, BH);
  kernel<<<grid, kThreads, kSmemBytesOf<E>,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(rk),
      static_cast<const E*>(rv), static_cast<const E*>(pk),
      static_cast<const E*>(pv),
      static_cast<const unsigned char*>(roll_valid),
      static_cast<const int*>(occupancy), static_cast<const int*>(frame_select),
      static_cast<E*>(out), n_head, nW, T, win, P, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sparse_window_attention(
    const void* q, const void* k, const void* v, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* roll_valid,
    const void* occupancy, const void* frame_select, void* out, int BH,
    int n_head, int nW, int T, int win, int P, float scale, void* stream) {
  return launch<float>(sparse_window_attention_kernel, configured, q, k, v,
                       rk, rv, pk, pv, roll_valid, occupancy, frame_select,
                       out, BH, n_head, nW, T, win, P, scale, stream);
}

// The bf16 form: q, k, v, rolled and pooled windows and out bf16.
extern "C" int sparse_window_attention_bf16(
    const void* q, const void* k, const void* v, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* roll_valid,
    const void* occupancy, const void* frame_select, void* out, int BH,
    int n_head, int nW, int T, int win, int P, float scale, void* stream) {
  return launch<__nv_bfloat16>(sparse_window_attention_bf16_kernel,
                               configured_bf16, q, k, v, rk, rv, pk, pv,
                               roll_valid, occupancy, frame_select, out, BH,
                               n_head, nW, T, win, P, scale, stream);
}

// Launch facts for chip_smoke.py's build phase (attention_tile.cuh:
// launch_info).
extern "C" int sparse_window_attention_launch_info(void* info, void*) {
  return launch_info(sparse_window_attention_kernel, configured, kSplit,
                     static_cast<int*>(info));
}

extern "C" int sparse_window_attention_bf16_launch_info(void* info, void*) {
  return launch_info<__nv_bfloat16>(sparse_window_attention_bf16_kernel,
                                    configured_bf16, kSplit,
                                    static_cast<int*>(info));
}
