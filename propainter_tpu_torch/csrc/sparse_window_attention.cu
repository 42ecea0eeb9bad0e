// K5: mask-guided sparse window attention, fp32 logits and softmax.
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
// Here one block per (batch*head, window, 128-query tile) of the window's
// T * win query rows (7 tiles of 855 rows) streams 64-key tiles through
// the online softmax of attention_tile.cuh (shared with K4). Each block
// reads its window's occupancy and takes its branch:
//   dirty (occupancy > 0): one softmax over, for each selected frame, the
//     window's win keys, the valid keys of the rolled band and the P
//     pooled keys — a flat list of n_sel * (win + n_valid + P) keys whose
//     rows the block looks up per tile. The TPU kernel instead masks
//     unselected frames and invalid rolled keys with -1e9 and starts its
//     running max at -1e9; their weights then vanish at the first live
//     frame (exp(-1e9 - m) = 0), so skipping them is exactly equal.
//     With no selected frame at all the TPU kernel's every logit is -1e9,
//     every key gets weight 1, and its output is the plain mean of v over
//     all T frames' win + 4 * win + P keys, invalid rolled keys included;
//     this kernel writes that mean. (The pipeline never asks for it: the
//     local frames are always selected.)
//   clean: each query attends its own frame's win keys; the block streams
//     the frames its rows span (at most 4), one tile each, masking the
//     pairs of other frames.
// Bound: operations — dirty windows 4 * (T * win) * keys * 128 FLOPs per
// (batch*head), clean ones T * 4 * win^2 * 128 — on CUDA cores; the rolled
// copies (112 MB each at 432x240) are read once per query tile.

#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int kMaxT = 64;          // frames
constexpr int kMaxRolled = 4 * kBK;  // 4 * win, win <= one key tile

__global__ void __launch_bounds__(kThreads)
sparse_window_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ rk,
    const float* __restrict__ rv, const float* __restrict__ pk,
    const float* __restrict__ pv, const unsigned char* __restrict__ roll_valid,
    const int* __restrict__ occupancy, const int* __restrict__ frame_select,
    float* __restrict__ o, int n_head, int nW, int T, int win, int P,
    float scale) {
  extern __shared__ float smem[];
  __shared__ const float* key_k[kBK];
  __shared__ const float* key_v[kBK];
  __shared__ int sel[kMaxT];
  __shared__ int rolled[kMaxRolled];
  __shared__ int n_sel_s, n_rolled_s;
  const Smem sm = carve(smem);

  const int bh = blockIdx.z, w = blockIdx.y;
  const int b = bh / n_head;
  const int q0 = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, T * win - q0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t win_base = (static_cast<size_t>(bh) * nW + w) * T * win * kD;
  const float* kw = k + win_base;
  const float* vw = v + win_base;
  const float* rkw = rk + 4 * win_base;
  const float* rvw = rv + 4 * win_base;
  const size_t pool_base = static_cast<size_t>(bh) * T * P * kD;
  const float* pkw = pk + pool_base;
  const float* pvw = pv + pool_base;
  float* ow = o + win_base + static_cast<size_t>(q0) * kD;

  load_queries(sm, q + win_base + static_cast<size_t>(q0) * kD, n_rows);
  Running run;
  init(run);

  if (occupancy[b * nW + w] > 0) {
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < T; ++t)
        if (frame_select[b * T + t] > 0) sel[n++] = t;
      n_sel_s = n;
      n = 0;
      for (int i = 0; i < 4 * win; ++i)
        if (roll_valid[i]) rolled[n++] = i;
      n_rolled_s = n;
    }
    __syncthreads();
    const int n_sel = n_sel_s, n_valid = n_rolled_s;
    if (n_sel == 0) {
      // every key of every frame with weight 1 (see the note above)
      const int n_keys = T * (5 * win + P);
      for (int d = tid; d < kD; d += kThreads) {
        float s = 0.f;
        for (int r = 0; r < T * win; ++r) s += vw[static_cast<size_t>(r) * kD + d];
        for (int r = 0; r < 4 * T * win; ++r)
          s += rvw[static_cast<size_t>(r) * kD + d];
        for (int r = 0; r < T * P; ++r) s += pvw[static_cast<size_t>(r) * kD + d];
        const float mean = s / static_cast<float>(n_keys);
        for (int r = 0; r < n_rows; ++r) ow[static_cast<size_t>(r) * kD + d] = mean;
      }
      return;
    }
    const int per_frame = win + n_valid + P;
    const int n_keys = n_sel * per_frame;
    for (int k0 = 0; k0 < n_keys; k0 += kBK) {
      __syncthreads();  // previous tile and its key table consumed
      if (tid < kBK) {
        const int key = k0 + tid;
        const float* kr = nullptr;
        const float* vr = nullptr;
        if (key < n_keys) {
          const int t = sel[key / per_frame];
          const int r = key % per_frame;
          if (r < win) {
            const size_t off = (static_cast<size_t>(t) * win + r) * kD;
            kr = kw + off;
            vr = vw + off;
          } else if (r < win + n_valid) {
            const int ri = rolled[r - win];
            const int shift = ri / win, i = ri % win;
            const size_t off =
                ((static_cast<size_t>(shift) * T + t) * win + i) * kD;
            kr = rkw + off;
            vr = rvw + off;
          } else {
            const size_t off =
                (static_cast<size_t>(t) * P + (r - win - n_valid)) * kD;
            kr = pkw + off;
            vr = pvw + off;
          }
        }
        key_k[tid] = kr;
        key_v[tid] = vr;
      }
      __syncthreads();
      load_keys(sm, [&](int c, const float*& kr, const float*& vr) {
        kr = key_k[c];
        vr = key_v[c];
        return kr != nullptr;
      });
      __syncthreads();
      float kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = k0 + tx * 4 + j < n_keys ? 0.f : -CUDART_INF_F;
      softmax_step(sm, run, scale, kb, [](int, int) { return true; });
    }
  } else {
    int row_frame[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) row_frame[i] = (q0 + ty * kRows + i) / win;
    const int t_last = (q0 + n_rows - 1) / win;
    for (int t = q0 / win; t <= t_last; ++t) {
      __syncthreads();
      load_keys(sm, [&](int c, const float*& kr, const float*& vr) {
        if (c >= win) return false;
        const size_t off = (static_cast<size_t>(t) * win + c) * kD;
        kr = kw + off;
        vr = vw + off;
        return true;
      });
      __syncthreads();
      float kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = tx * 4 + j < win ? 0.f : -CUDART_INF_F;
      softmax_step(sm, run, scale, kb,
                   [&](int i, int) { return row_frame[i] == t; });
    }
  }
  store(ow, n_rows, run);
}

bool configured = false;

}  // namespace

extern "C" int sparse_window_attention(
    const void* q, const void* k, const void* v, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* roll_valid,
    const void* occupancy, const void* frame_select, void* out, int BH,
    int n_head, int nW, int T, int win, int P, float scale, void* stream) {
  if (T > kMaxT || win > kBK || win < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = configure(sparse_window_attention_kernel, configured);
  if (err != 0) return err;
  const dim3 grid((T * win + kBQ - 1) / kBQ, nW, BH);
  sparse_window_attention_kernel<<<grid, kThreads, kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rk),
      static_cast<const float*>(rv), static_cast<const float*>(pk),
      static_cast<const float*>(pv),
      static_cast<const unsigned char*>(roll_valid),
      static_cast<const int*>(occupancy), static_cast<const int*>(frame_select),
      static_cast<float*>(out), n_head, nW, T, win, P, scale);
  return static_cast<int>(cudaGetLastError());
}
