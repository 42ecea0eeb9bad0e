// K1: RAFT radius-4 correlation lookup fused with the motion encoder's
// convc1 (1x1 conv 324 -> 256) and relu.
//
// Replaces propainter_tpu/ops/corr_pallas.py:_lookup_kernel (moenc
// epilogue). Semantics: propainter_tpu_torch/ops/corr.py:corr_lookup_moenc.
//
// Layout: level l of the pyramid is (N, H_l, W_l) fp32, row n = query n's
// correlation with every key pixel; coords (N, 2) pixel (x, y); weight
// (324, 256) row-major with row c = l*81 + i*9 + j (window sample at
// (x + i - 4, y + j - 4) / 2^l); out (N, 256).
//
// Design: a GEMM of M = N queries, N = 256 outputs and K = 324 window
// values (zero-padded to 336) on the tensor cores in 3xTF32 (tf32_mma.cuh),
// whose A operand, the window values, is built in shared memory and never
// reaches device memory. Persistent blocks of 4 warps, two per SM, walk
// 32-query tiles (warp wn: the 32 queries x outputs 64wn .. 64wn + 63, 64
// fp32 accumulators a thread). A tile's A rows stay in shared memory in
// fp32 (32 x 336, channel order), each value split big + small as it is
// loaded into a fragment. (Measured on an H100, PERF.md: 64-query tiles of
// 8 or 16 warps at one block per SM, 8 warps of 32 x 32 outputs, and A
// split once into big + small arrays were slower.)
//   gather   one warp per (query, level): lane (r, c) = (lane / 10, lane %
//            10) reads window row r + 3k, column c, of the 10 x 10 integer
//            window (zero outside the map), so each neighbour is read once
//            and a load touches one query's rows; shuffles then lerp rows
//            first, then columns, in the plain version's order and
//            rounding, into the level's 81 values of the A row. Offsets,
//            floors and fractions are computed once per (query, level).
//   overlap  the K walk is cut at the level boundaries into 4 steps of
//            16-channel groups (0-4, 5-9, 10-14, 15-20; a group of step s
//            reads levels <= s only). Step s issues the loads of level s + 1
//            (at s = 3, level 0 of the block's next tile) before its
//            products and lerps them into A after, so the gather's latency
//            hides behind the tensor cores; A columns are rewritten only
//            after the groups that read them.
//   weights  16-row chunks through a 3-slot cp.async ring issued two
//            groups ahead, continuing from tile to tile; each 4 x 4 (t, e)
//            block of rows lands transposed (row 4e + t holds channel 4t +
//            e) so the 128-bit B loads are free of bank conflicts (as K3).
//   epilogue bias + relu from the accumulators, 128-bit stores.
// Fragment numbering (as K3): k-step 2p + h of group p has slots t, t + 4
// on channels 16p + 4t + 2h and + 1, so one 128-bit load gives a thread its
// A values of two k-steps (row stride 336 = 16 mod 32: conflict-free); n-tile
// 4q + r has column g on output 32q + 4g + r (of the warp's 64), so the
// accumulators of a row hold 8 contiguous outputs.
// Bound: operations, 3 x 2 * 324 * 256 FLOPs per query on the tensor cores
// in TF32.
//
// The bf16 form (corr_lookup_moenc_bf16; the TPU kernel as the JAX bf16
// pipeline runs it, over a bf16 pyramid). Semantics:
// propainter_tpu_torch/ops/corr.py:corr_lookup_moenc_bf16. Levels are (N,
// H_l, W_l) bf16; the weight is convc1's own (256, 324) layout, row f =
// output f; bias bf16; out (N, 256) fp32. Each window value rounds where
// the TPU kernel rounds it: the row lerp in bf16 (fy rounded to bf16, each
// product and the sum rounded, corr_pallas.py:189-196), the column lerp in
// fp32 (:264-265), the value rounded to bf16 as the A operand; the weight
// is the B operand; one m16n8k16 bf16 pass with fp32 accumulators
// (:299-303, bf16_mma.cuh); bias + relu in fp32. A first, simple design:
// blocks of 8 warps own 64 queries x 256 outputs; the warps gather each
// (query, level)'s 10 x 10 window with the fp32 form's lane layout into
// a bf16 A tile in shared memory (64 x 336, padded channels zero), then
// warp (wm, wn) multiplies its 32 queries x 64 outputs, reading B
// fragments straight from the weight (L1-resident, 166 KB). No overlap of
// the gather with the products. Bound: bytes (the in-range taps read, in
// bf16, and the fp32 output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tc;

constexpr int kRadius = 4;
constexpr int kTaps = 2 * kRadius + 1;          // 9
constexpr int kWin = kTaps + 1;                 // 10 integer taps a side
constexpr int kLevels = 4;
constexpr int kLevelC = kTaps * kTaps;          // 81
constexpr int kC = kLevels * kLevelC;           // 324
constexpr int kCP = 336;                        // K padded to 16-channel groups
constexpr int kGroups = kCP / 16;               // 21
constexpr int kF = 256;                         // convc1 outputs
constexpr int kBQ = 32;                         // queries per tile
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 2;                 // resident blocks asked for
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsN = kWarps / (kBQ / 32);    // warps along the outputs
constexpr int kNQ = kF / kWarpsN / 32;          // 32-output blocks a warp
constexpr int kQW = kBQ / kWarps;               // queries a warp gathers
constexpr int kSlots = 3;                       // weight ring
constexpr int kLdA = kCP;                       // = 16 mod 32
constexpr int kLdW = kF + 8;                    // = 8 mod 32
constexpr int kAFloats = kBQ * kLdA;
constexpr int kWFloats = 16 * kLdW;
constexpr size_t kSmemBytes = sizeof(float) * (kAFloats + kSlots * kWFloats);
// step s walks groups 5s .. 5s + 4 (the last step to the end), which read
// only channels below 81 (s + 1): the levels gathered before it
constexpr int kStepGroups = 5;
static_assert(16 * kStepGroups <= kLevelC && kC <= kCP,
              "a step's groups read only the levels gathered before it");
static_assert(kLdA % 32 == 16 && kLdW % 32 == 8, "conflict-free fragments");
static_assert(kBQ % 32 == 0 && kWarps % (kBQ / 32) == 0 && kNQ >= 1
                  && kBQ % kWarps == 0 && 16 * kF % (4 * kThreads) == 0,
              "warps tile the block's queries x outputs");

struct Levels {
  const float* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
corr_lookup_moenc_kernel(Levels lv, const float* __restrict__ coords,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int n_query, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* const a = smem;                        // [kBQ][kLdA]
  float* const ring = smem + kAFloats;          // [kSlots][16][kLdW]
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int r = lane / kWin, c = lane % kWin;   // gather: window row, column
  const bool glane = lane < 3 * kWin;

  // query (tile, kQW warp + i) at level l: whether it exists, and its
  // coordinates at the level
  auto query = [&](int tile, int l, int i, float& x, float& y) {
    const int n = tile * kBQ + kQW * warp + i;
    const bool live = n < n_query;
    const float scale = 1.f / static_cast<float>(1 << l);
    x = live ? __ldg(coords + 2 * static_cast<size_t>(n)) * scale : 0.f;
    y = live ? __ldg(coords + 2 * static_cast<size_t>(n) + 1) * scale : 0.f;
    return live;
  };
  // lane (r, c)'s integer taps of the window, loads k = 0..3: rows r + 3k
  auto load_level = [&](int tile, int l, float (&gv)[kQW][4]) {
    const int H = lv.h[l], W = lv.w[l];
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      float x, y;
      const bool live = query(tile, l, i, x, y) && glane;
      // a window wholly outside the map stays wholly outside after the
      // clamp, which keeps the integer taps small
      const int xs = static_cast<int>(fminf(fmaxf(floorf(x), -6.f), W + 4.f))
                     - kRadius + c;
      const int ys = static_cast<int>(fminf(fmaxf(floorf(y), -6.f), H + 4.f))
                     - kRadius + r;
      const size_t n = static_cast<size_t>(tile) * kBQ + kQW * warp + i;
      const float* m = lv.ptr[l] + (live ? n * H * W : 0);
      const bool col_in = live && xs >= 0 && xs < W;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yy = ys + 3 * k;
        const bool in = col_in && r + 3 * k < kWin && yy >= 0 && yy < H;
        gv[i][k] = in ? __ldg(m + yy * W + xs) : 0.f;
      }
    }
  };
  // the level's 81 A values of each query: rows lerped by fy (row below
  // from lane + 10, or from the next load's lane c - 20), then columns by
  // fx (the column right from lane + 1); channel l*81 + c*9 + row
  auto store_level = [&](int tile, int l, const float (&gv)[kQW][4]) {
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      float x, y;
      query(tile, l, i, x, y);
      const float fx = x - floorf(x), fy = y - floorf(y);
      float* row = a + (kQW * warp + i) * kLdA + l * kLevelC;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float up = __shfl_down_sync(0xffffffffu, gv[i][k], kWin);
        const float wrap = __shfl_up_sync(0xffffffffu, gv[i][k + 1],
                                          2 * kWin);
        const float below = r < 2 ? up : wrap;
        const float gy = __fadd_rn(__fmul_rn(gv[i][k], 1.f - fy),
                                   __fmul_rn(below, fy));
        const float right = __shfl_down_sync(0xffffffffu, gy, 1);
        const float v = __fadd_rn(__fmul_rn(gy, 1.f - fx),
                                  __fmul_rn(right, fx));
        if (glane && c < kTaps) row[c * kTaps + 3 * k + r] = v;
      }
    }
  };
  auto issue_weights = [&](int p, int slot) {
    float* dst = ring + slot * kWFloats;
#pragma unroll
    for (int i = 0; i < 16 * kF / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int cc = e / (kF / 4), col = 4 * (e % (kF / 4));
      const int ch = 16 * p + cc;
      const bool live = ch < kC;
      cp_async16(dst + (((cc & 3) << 2) | (cc >> 2)) * kLdW + col,
                 weight + (live ? ch * kF + col : 0), live);
    }
  };

  float acc[2][4 * kNQ][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4 * kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  };
  auto products = [&](int p, int slot) {
    const float* ws = ring + slot * kWFloats + 32 * kNQ * wn + 4 * g;
    float4 av[2][2];   // [m-tile][rows g, g + 8]: channels 16p + 4t .. + 3
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        av[mi][hh] = *reinterpret_cast<const float4*>(
            a + (32 * wm + 16 * mi + 8 * hh + g) * kLdA + 16 * p + 4 * t);
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      uint32_t fb[2][4], fs[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split(lane4(av[mi][0], 2 * hk), fb[mi][0], fs[mi][0]);
        split(lane4(av[mi][1], 2 * hk), fb[mi][1], fs[mi][1]);
        split(lane4(av[mi][0], 2 * hk + 1), fb[mi][2], fs[mi][2]);
        split(lane4(av[mi][1], 2 * hk + 1), fb[mi][3], fs[mi][3]);
      }
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        // slot t: channel 16p + 4t + 2hk at row 8hk + t; slot t + 4: the
        // next channel, 4 rows on
        const float* wr = ws + (8 * hk + t) * kLdW + 32 * q;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 4 * kLdW);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          uint32_t b0, b0s, b1, b1s;
          split(lane4(w0, rr), b0, b0s);
          split(lane4(w1, rr), b1, b1s);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma3(acc[mi][4 * q + rr], fb[mi], fs[mi], b0, b0s, b1, b1s);
          }
        }
      }
    }
  };
  // rows g, g + 8 of each m-tile: outputs 32 kNQ wn + 32q + 8t .. + 7
  auto epilogue = [&](int tile) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = tile * kBQ + 32 * wm + 16 * mi + 8 * hh + g;
        if (n >= n_query) continue;
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          const int col = 32 * kNQ * wn + 32 * q + 8 * t;
          const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + col));
          const float4 b1 =
              __ldg(reinterpret_cast<const float4*>(bias + col + 4));
          float* dst = out + static_cast<size_t>(n) * kF + col;
          const auto& sums = acc[mi];
          *reinterpret_cast<float4*>(dst) = make_float4(
              fmaxf(sums[4 * q][2 * hh] + b0.x, 0.f),
              fmaxf(sums[4 * q + 1][2 * hh] + b0.y, 0.f),
              fmaxf(sums[4 * q + 2][2 * hh] + b0.z, 0.f),
              fmaxf(sums[4 * q + 3][2 * hh] + b0.w, 0.f));
          *reinterpret_cast<float4*>(dst + 4) = make_float4(
              fmaxf(sums[4 * q][2 * hh + 1] + b1.x, 0.f),
              fmaxf(sums[4 * q + 1][2 * hh + 1] + b1.y, 0.f),
              fmaxf(sums[4 * q + 2][2 * hh + 1] + b1.z, 0.f),
              fmaxf(sums[4 * q + 3][2 * hh + 1] + b1.w, 0.f));
        }
      }
  };

  // the padding channels stay zero; the weight ring starts two groups
  // ahead; the first tile's level 0 is gathered before any product
  for (int e = tid; e < kBQ * (kCP - kC); e += kThreads)
    a[e / (kCP - kC) * kLdA + kC + e % (kCP - kC)] = 0.f;
  issue_weights(0, 0);
  cp_async_commit();
  issue_weights(1, 1);
  cp_async_commit();
  float gv[kQW][4];
  load_level(blockIdx.x, 0, gv);
  store_level(blockIdx.x, 0, gv);
  zero_acc();

  int j = 0;   // groups walked by this block: weights in slot j % kSlots
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int s = 0; s < kLevels; ++s) {
      const int next_tile = s + 1 < kLevels ? tile : tile + gridDim.x;
      const int next_l = (s + 1) % kLevels;
      const bool more = next_tile < n_tiles;
      if (more) load_level(next_tile, next_l, gv);
      const int p1 = s + 1 < kLevels ? kStepGroups * (s + 1) : kGroups;
      for (int p = kStepGroups * s; p < p1; ++p, ++j) {
        cp_async_wait<1>();
        __syncthreads();   // group p's weights and A columns visible; the
                           // slot of group j - 1 consumed
        issue_weights((p + 2) % kGroups, (j + 2) % kSlots);
        cp_async_commit();
        products(p, j % kSlots);
      }
      if (more) store_level(next_tile, next_l, gv);
      if (s + 1 == kLevels) {
        epilogue(tile);
        zero_acc();
      }
    }
  }
  cp_async_wait<0>();
}

// ---- the bf16 form -------------------------------------------------------

constexpr int kBQb = 64;                        // queries per block
constexpr int kThreadsB = 256;                  // 8 warps
constexpr int kLdAb = 344;                      // bf16 per A row: 172 words
                                                // = 12 mod 32, conflict-free
static_assert(kLdAb >= kCP && (kLdAb / 2) % 32 == 12, "A tile layout");

struct LevelsBf16 {
  const __nv_bfloat16* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

__global__ void __launch_bounds__(kThreadsB)
corr_lookup_moenc_bf16_kernel(LevelsBf16 lv, const float* __restrict__ coords,
                              const __nv_bfloat16* __restrict__ weight,
                              const __nv_bfloat16* __restrict__ bias,
                              float* __restrict__ out, int n_query) {
  __shared__ __align__(16) __nv_bfloat16 a[kBQb * kLdAb];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int r = lane / kWin, c = lane % kWin;   // gather: window row, column
  const bool glane = lane < 3 * kWin;
  const int q0 = blockIdx.x * kBQb;

  for (int e = tid; e < kBQb * (kCP - kC); e += kThreadsB)
    a[e / (kCP - kC) * kLdAb + kC + e % (kCP - kC)] = __float2bfloat16(0.f);

  // gather: warp w takes queries 8w .. 8w + 7 at every level
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const float scale = 1.f / static_cast<float>(1 << l);
    for (int i = 0; i < kBQb / 8; ++i) {
      const int qi = 8 * warp + i;
      const int n = q0 + qi;
      const bool live = n < n_query;
      const float x =
          live ? __ldg(coords + 2 * static_cast<size_t>(n)) * scale : 0.f;
      const float y =
          live ? __ldg(coords + 2 * static_cast<size_t>(n) + 1) * scale : 0.f;
      const float x0 = floorf(x), y0 = floorf(y);
      const int xs = static_cast<int>(fminf(fmaxf(x0, -6.f), W + 4.f))
                     - kRadius + c;
      const int ys = static_cast<int>(fminf(fmaxf(y0, -6.f), H + 4.f))
                     - kRadius + r;
      const __nv_bfloat16* m =
          lv.ptr[l] + (live ? static_cast<size_t>(n) * H * W : 0);
      const bool col_in = live && glane && xs >= 0 && xs < W;
      float gv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yy = ys + 3 * k;
        const bool in = col_in && r + 3 * k < kWin && yy >= 0 && yy < H;
        gv[k] = in ? __bfloat162float(m[yy * W + xs]) : 0.f;
      }
      // row lerp in bf16, column lerp in fp32, the value rounded to bf16
      const float fyb = bf::round_bf16(y - y0);
      const float omfy = bf::round_bf16(1.f - fyb);
      const float fx = x - x0;
      __nv_bfloat16* row = a + qi * kLdAb + l * kLevelC;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float up = __shfl_down_sync(0xffffffffu, gv[k], kWin);
        const float wrap = __shfl_up_sync(0xffffffffu, gv[k + 1], 2 * kWin);
        const float below = r < 2 ? up : wrap;
        const float gy = bf::round_bf16(
            __fadd_rn(bf::round_bf16(__fmul_rn(gv[k], omfy)),
                      bf::round_bf16(__fmul_rn(below, fyb))));
        const float right = __shfl_down_sync(0xffffffffu, gy, 1);
        const float v = __fadd_rn(__fmul_rn(gy, 1.f - fx),
                                  __fmul_rn(right, fx));
        if (glane && c < kTaps)
          row[c * kTaps + 3 * k + r] = __float2bfloat16_rn(v);
      }
    }
  }
  __syncthreads();

  // products: warp (wm, wn) = 32 queries x 64 outputs
  const int wm = warp / 4, wn = warp % 4;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
  for (int s = 0; s < kCP / 16; ++s) {
    uint32_t fa[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = 32 * wm + 16 * mi + g;
      const int w0 = (row * kLdAb + 16 * s) / 2 + t;
      fa[mi][0] = aw[w0];
      fa[mi][1] = aw[w0 + 4 * kLdAb];
      fa[mi][2] = aw[w0 + 4];
      fa[mi][3] = aw[w0 + 4 * kLdAb + 4];
    }
    const int k0 = 16 * s + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // column f's k pairs; channels past 324 read as zero
      const __nv_bfloat16* wr =
          weight + static_cast<size_t>(64 * wn + 8 * j + g) * kC;
      const uint32_t b0 =
          k0 < kC ? __ldg(reinterpret_cast<const unsigned int*>(wr + k0)) : 0u;
      const uint32_t b1 =
          k0 + 8 < kC
              ? __ldg(reinterpret_cast<const unsigned int*>(wr + k0 + 8))
              : 0u;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) bf::mma(acc[mi][j], fa[mi], b0, b1);
    }
  }

  // bias + relu: rows g, g + 8 of each m-tile, columns 2t, 2t + 1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = q0 + 32 * wm + 16 * mi + 8 * hh + g;
      if (n >= n_query) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * wn + 8 * j + 2 * t;
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
        *reinterpret_cast<float2*>(out + static_cast<size_t>(n) * kF + col) =
            make_float2(fmaxf(acc[mi][j][2 * hh] + b.x, 0.f),
                        fmaxf(acc[mi][j][2 * hh + 1] + b.y, 0.f));
      }
    }
}

// The shared-memory limit is an attribute of the kernel on one device and
// the persistent grid depends on that device's SMs, so both are set up
// once per device, for the device current at the call (the wrapper makes
// the tensors' device current).
constexpr int kMaxDevices = 64;
bool configured[kMaxDevices] = {};
int resident[kMaxDevices] = {};   // blocks the device holds at once

// the current device's index in `dev`, its setup done
int configure(int& dev) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (configured[dev]) return 0;
  err = cudaFuncSetAttribute(
      corr_lookup_moenc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, corr_lookup_moenc_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  resident[dev] = n_sm * per_sm;
  configured[dev] = true;
  return 0;
}

}  // namespace

// weight, bias and out 16-byte aligned (the wrapper checks).
extern "C" int corr_lookup_moenc(const void* l0, const void* l1,
                                 const void* l2, const void* l3,
                                 const void* coords, const void* weight,
                                 const void* bias, void* out, int n_query,
                                 int h0, int w0, int h1, int w1, int h2,
                                 int w2, int h3, int w3, void* stream) {
  int dev = 0;
  const int err = configure(dev);
  if (err != 0) return err;
  Levels lv;
  lv.ptr[0] = static_cast<const float*>(l0);
  lv.ptr[1] = static_cast<const float*>(l1);
  lv.ptr[2] = static_cast<const float*>(l2);
  lv.ptr[3] = static_cast<const float*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int n_tiles = (n_query + kBQ - 1) / kBQ;
  const int blocks = n_tiles < resident[dev] ? n_tiles : resident[dev];
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  corr_lookup_moenc_kernel<<<blocks, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(out), n_query, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts for chip_smoke.py's build phase: info = {resident blocks
// per SM, dynamic shared memory bytes, threads per block, queries per
// tile, 1}; min(tiles, SMs x resident blocks per SM) persistent blocks
// walk the tiles.
extern "C" int corr_lookup_moenc_launch_info(void* info, void*) {
  int dev = 0;
  const int err = configure(dev);
  if (err != 0) return err;
  int* i = static_cast<int*>(info);
  i[1] = static_cast<int>(kSmemBytes);
  i[2] = kThreads;
  i[3] = kBQ;
  i[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      i, corr_lookup_moenc_kernel, kThreads, kSmemBytes));
}

// The bf16 form: levels bf16, coords fp32, weight (256, 324) bf16, bias
// (256) bf16, out (N, 256) fp32; all contiguous (the wrapper checks).
extern "C" int corr_lookup_moenc_bf16(const void* l0, const void* l1,
                                      const void* l2, const void* l3,
                                      const void* coords, const void* weight,
                                      const void* bias, void* out,
                                      int n_query, int h0, int w0, int h1,
                                      int w1, int h2, int w2, int h3, int w3,
                                      void* stream) {
  LevelsBf16 lv;
  lv.ptr[0] = static_cast<const __nv_bfloat16*>(l0);
  lv.ptr[1] = static_cast<const __nv_bfloat16*>(l1);
  lv.ptr[2] = static_cast<const __nv_bfloat16*>(l2);
  lv.ptr[3] = static_cast<const __nv_bfloat16*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int blocks = (n_query + kBQb - 1) / kBQb;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  corr_lookup_moenc_bf16_kernel<<<blocks, kThreadsB, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<const __nv_bfloat16*>(bias), static_cast<float*>(out),
      n_query);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the bf16 form (as corr_lookup_moenc_launch_info; one
// block per 64-query tile, static shared memory).
extern "C" int corr_lookup_moenc_bf16_launch_info(void* info, void*) {
  int* i = static_cast<int*>(info);
  i[1] = 0;
  i[2] = kThreadsB;
  i[3] = kBQb;
  i[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      i, corr_lookup_moenc_bf16_kernel, kThreadsB, 0));
}
