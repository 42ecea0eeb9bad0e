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

// The bf16 form (sparse_window_attention_bf16; the TPU kernel on the bf16
// windows of the JAX bf16 pipeline, which upcasts q, k and v to fp32 and
// writes its output in bf16, attention.py:51, 62-68, 84, 98-99, 197).
// Semantics: propainter_tpu_torch/ops/attention.py:
// sparse_window_attention_bf16. q, k, v, rolled and pooled windows and
// the output bf16; roll_valid, occupancy and frame_select as above. It
// runs on the wgmma tile of attention_wgmma.cuh: one block of a producer
// and two consumer warpgroups per (batch*head, window, 128-query tile), 7
// tiles of 855 rows. Q·Kᵀ is one bf16 pass with fp32 sums (the products
// of bf16 values are exact in fp32), the scale applied to the fp32
// logits; the TPU kernel scales the upcast q first, so the two differ in
// fp32 rounding only. p stays fp32 in the TPU kernel's P·V, so P goes in
// as bf16 hi + bf16 lo (lo = p - hi) over the same V tile: 16 significant
// bits of p, a relative error of at most 2^-17. Every sum, the softmax
// and the final division are fp32, and the output is rounded once.
// TMA cannot gather rows, so the producer warpgroup fills the ring's
// swizzled tiles with 16-byte cp.async (two threads per key row, one
// 64-column atom each; the consumers fence the async proxy after each
// wait) and signals each full barrier with cp.async.mbarrier.arrive.noinc:
//   dirty: the same flat key list as above (selected frames' window keys,
//     valid rolled keys, pooled keys), no split over a cluster; with no
//     selected frame, the mean of v over all keys, as above;
//   clean: the contiguous keys of the frames the block's 128 rows span
//     (at most 4 at win = 45), pairs across frames masked.
// The copies bound it where windows are dirty: on an H100 the copies alone
// take most of an all-dirty call (PERF.md §7). Tried there and slower:
// TMA boxes of 8 or 16 rows over runs padded to multiples of 8, and a
// cluster pair sharing each tile's halves through distributed shared
// memory.
// Bound: operations, 1 + 2 bf16 passes each over half the product FLOPs
// (1.5 x the product FLOPs at the bf16 tensor-core rate) where windows
// are dirty.

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

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
  extern __shared__ __align__(16) float smem[];
  __shared__ int sel[kMaxT];
  __shared__ int rolled[kMaxRolled];   // rolled rows of frame 0
  __shared__ int key_row[kStages][kBK];
  __shared__ int n_sel_s, n_rolled_s;
  const Smem sm = carve(smem);

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
  const float* kw = k + win_base;
  const float* vw = v + win_base;
  const float* rkw = rk + 4 * win_base;
  const float* rvw = rv + 4 * win_base;
  const size_t pool_base = static_cast<size_t>(bh) * T * P * kD;
  const float* pkw = pk + pool_base;
  const float* pvw = pv + pool_base;
  float* ow = o + win_base + static_cast<size_t>(q0) * kD;

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
        [&](int, int slot, int c, const float*& kr, const float*& vr) {
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
        [&](int tile, int, int c, const float*& kr, const float*& vr) {
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

bool configured[kMaxDevices] = {};   // per device (attention_tile.cuh)

// ---- the bf16 form --------------------------------------------------------

// the wgmma tile with key tiles of 64 keys (room for P's hi and lo; the
// producer's two threads per key row cover 64 rows)
using Tile = wga::Ring<64>;

__global__ void __launch_bounds__(wga::kThreads, 1)
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
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sel[kMaxT];
  __shared__ int rolled[kMaxRolled];   // rolled rows of frame 0
  __shared__ int n_sel_s, n_rolled_s;
  const Tile sm = wga::carve<Tile::kBN>(smem_raw);

  const int bh = blockIdx.z, w = blockIdx.y;
  const int b = bh / n_head;
  const int q0 = blockIdx.x * wga::kBQ;
  const int n_rows = min(wga::kBQ, T * win - q0);
  const bool dirty = occupancy[b * nW + w] > 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t win_base =
      (static_cast<size_t>(bh) * nW + w) * T * win * wga::kD;
  const bf16* kw = k + win_base;
  const bf16* vw = v + win_base;
  const bf16* rkw = rk + 4 * win_base;
  const bf16* rvw = rv + 4 * win_base;
  const size_t pool_base = static_cast<size_t>(bh) * T * P * wga::kD;
  const bf16* pkw = pk + pool_base;
  const bf16* pvw = pv + pool_base;
  const bf16* qw = q + win_base + static_cast<size_t>(q0) * wga::kD;
  bf16* ow = o + win_base + static_cast<size_t>(q0) * wga::kD;

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
  }
  wga::init_barriers(sm, 128);
  __syncthreads();
  const int n_sel = dirty ? n_sel_s : 0, n_valid = dirty ? n_rolled_s : 0;
  if (dirty && n_sel == 0) {
    // every key of every frame with weight 1 (see the note above)
    const int n_keys = T * (5 * win + P);
    for (int d = tid; d < wga::kD; d += wga::kThreads) {
      float s = 0.f;
      for (int r = 0; r < T * win; ++r)
        s += __bfloat162float(vw[static_cast<size_t>(r) * wga::kD + d]);
      for (int r = 0; r < 4 * T * win; ++r)
        s += __bfloat162float(rvw[static_cast<size_t>(r) * wga::kD + d]);
      for (int r = 0; r < T * P; ++r)
        s += __bfloat162float(pvw[static_cast<size_t>(r) * wga::kD + d]);
      const float mean = s / static_cast<float>(n_keys);
      for (int r = 0; r < n_rows; ++r)
        ow[static_cast<size_t>(r) * wga::kD + d] = __float2bfloat16_rn(mean);
    }
    return;
  }
  // the block's keys: dirty, the flat list of the selected frames; clean,
  // the frames f0 .. f1 that its rows span, from key row key0
  const int per_frame = win + n_valid + P;
  const int f0 = q0 / win, f1 = (q0 + n_rows - 1) / win;
  const int key0 = f0 * win;
  const int n_keys = dirty ? n_sel * per_frame : (f1 - f0 + 1) * win;
  const int n_tiles = (n_keys + Tile::kBN - 1) / Tile::kBN;

  const int group = wga::warpgroup();
  if (group == 0) {
    wga::producer_regs();
    // Q: 128 rows of 16 chunks, zeros past n_rows
#pragma unroll
    for (int i = 0; i < wga::kBQ * 16 / 128; ++i) {
      const int e = tid + 128 * i, r = e / 16, c = e % 16;
      const bool live = r < n_rows;
      wga::cp_async16(sm.q() + wga::swizzled(r, c, wga::kQAtom),
                      qw + (live ? r * wga::kD + 8 * c : 0), live);
    }
    wga::bar_arrive_cp_async(sm.q_full());
    // key c of each tile, 64-column atom h
    const int c = tid / 2, h = tid % 2;
    for (int j = 0; j < n_tiles; ++j) {
      const int key = j * Tile::kBN + c;
      const bf16* kr = kw;
      const bf16* vr = vw;
      const bool live = key < n_keys;
      if (live && dirty) {
        const int f = key / per_frame, r = key - f * per_frame;
        const int t = sel[f];
        size_t off;
        if (r < win) {
          off = static_cast<size_t>(t * win + r) * wga::kD;
        } else if (r < win + n_valid) {
          off = static_cast<size_t>(rolled[r - win] + t * win) * wga::kD;
          kr = rkw;
          vr = rvw;
        } else {
          off = static_cast<size_t>(t * P + r - win - n_valid) * wga::kD;
          kr = pkw;
          vr = pvw;
        }
        kr += off;
        vr += off;
      } else if (live) {
        kr += static_cast<size_t>(key0 + key) * wga::kD;
        vr += static_cast<size_t>(key0 + key) * wga::kD;
      }
      const int st = j % Tile::kStages;
      const int parity = ((j / Tile::kStages) & 1) ^ 1;   // slot freed
      wga::bar_wait(sm.k_empty(st), parity);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        wga::cp_async16(
            sm.k(st) + wga::swizzled(c, 8 * h + cc, Tile::kTileAtom),
            kr + 64 * h + 8 * cc, live);
      wga::bar_arrive_cp_async(sm.k_full(st));
      wga::bar_wait(sm.v_empty(st), parity);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        wga::cp_async16(
            sm.v(st) + wga::swizzled(c, 8 * h + cc, Tile::kTileAtom),
            vr + 64 * h + 8 * cc, live);
      wga::bar_arrive_cp_async(sm.v_full(st));
    }
  } else {
    wga::consumer_regs();
    const int cg = group - 1;
    const int g = lane / 4, t4 = lane % 4;
    const float qscale = scale * wga::kLog2e;
    auto key_bias = [&](int tile, float (&kb)[Tile::kBlocks][2]) {
#pragma unroll
      for (int j = 0; j < Tile::kBlocks; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          kb[j][e] = tile * Tile::kBN + 8 * j + 2 * t4 + e < n_keys
                         ? 0.f : -CUDART_INF_F;
    };
    wga::Rows r;
    wga::bar_wait(sm.q_full(), 0);
    if (dirty) {
      wga::consume<Tile::kBN, true, true>(
          sm, cg, n_tiles, qscale, key_bias,
          [](int, int, int, int) { return true; }, r);
    } else {
      // the keys of rows g and g + 8's own frames, from key0
      const int row = q0 + 64 * cg + 16 * (warp % 4) + g;
      const int lo[2] = {row / win * win - key0, (row + 8) / win * win - key0};
      wga::consume<Tile::kBN, true, true>(
          sm, cg, n_tiles, qscale, key_bias,
          [&](int tile, int i, int j, int e) {
            const int key = tile * Tile::kBN + 8 * j + 2 * t4 + e;
            return key >= lo[i] && key < lo[i] + win;
          },
          r);
    }
    wga::store(ow, cg, n_rows, r);
  }
}

bool configured_bf16[wga::kMaxDevices] = {};

}  // namespace

extern "C" int sparse_window_attention(
    const void* q, const void* k, const void* v, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* roll_valid,
    const void* occupancy, const void* frame_select, void* out, int BH,
    int n_head, int nW, int T, int win, int P, float scale, void* stream) {
  if (T > kMaxT || win > kMaxWin || win < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = configure(sparse_window_attention_kernel, configured);
  if (err != 0) return err;
  const dim3 grid((T * win + kBQ - 1) / kBQ * kSplit, nW, BH);
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

// Launch facts for chip_smoke.py's build phase (attention_tile.cuh:
// launch_info).
extern "C" int sparse_window_attention_launch_info(void* info, void*) {
  return launch_info(sparse_window_attention_kernel, configured, kSplit,
                     static_cast<int*>(info));
}

// The bf16 form: q, k, v, rolled and pooled windows and out bf16, 16-byte
// aligned.
extern "C" int sparse_window_attention_bf16(
    const void* q, const void* k, const void* v, const void* rk,
    const void* rv, const void* pk, const void* pv, const void* roll_valid,
    const void* occupancy, const void* frame_select, void* out, int BH,
    int n_head, int nW, int T, int win, int P, float scale, void* stream) {
  if (T > kMaxT || win > kMaxWin || win < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      wga::configure<Tile::kBN>(sparse_window_attention_bf16_kernel,
                                configured_bf16);
  if (err != 0) return err;
  const dim3 grid((T * win + wga::kBQ - 1) / wga::kBQ, nW, BH);
  using bf16 = __nv_bfloat16;
  sparse_window_attention_bf16_kernel<<<grid, wga::kThreads, Tile::kSmemBytes,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rk),
      static_cast<const bf16*>(rv), static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv),
      static_cast<const unsigned char*>(roll_valid),
      static_cast<const int*>(occupancy), static_cast<const int*>(frame_select),
      static_cast<bf16*>(out), n_head, nW, T, win, P, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the bf16 form (attention_wgmma.cuh: launch_info).
extern "C" int sparse_window_attention_bf16_launch_info(void* info, void*) {
  return wga::launch_info<Tile::kBN>(sparse_window_attention_bf16_kernel,
                                     configured_bf16,
                                     static_cast<int*>(info));
}
