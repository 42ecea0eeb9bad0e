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
// H_l, W_l) bf16; the weight convc1's rows K-major, (256, 336) with
// channels 324 .. 335 zero (the wrapper's copy); bias bf16; out (N, 256)
// fp32. Each window value rounds where the TPU kernel rounds it: the row
// lerp in bf16 (fy rounded to bf16, each product and the sum rounded,
// corr_pallas.py:189-196), the column lerp in fp32 (:264-265), the value
// rounded to bf16 as the A operand; one bf16 pass with fp32 sums
// (:299-303); bias + relu in fp32.
// Bound: bytes (the in-range bf16 taps and the 40 MB fp32 output of one
// RAFT iteration; the products are 0.4x that time at the bf16 rate). What
// holds it back is the gather: chains of dependent loads, shuffles and
// roundings per (query, level) and warp, which need many warps in flight
// to hide their latency.
// Design: persistent blocks of 1024 threads, one per SM (the weight fills
// its shared memory), walk 64-query tiles; warp-specialised. convc1's
// whole weight stays in shared memory as wgmma's B operand, loaded once
// by cp.async; both operands are K-major in the 32-byte swizzle, whose
// k-step blocks of 16 channels take K = 336 without padding to a 128-byte
// atom (172 KB of weight + 43 KB for the one A tile).
//   producers 16 warps; warp p gathers queries p + 16q of the tile, level
//             by level, with K7's lane layout (lane (r, c) reads window
//             rows r + 3k, column c: each neighbour once; a query's
//             coordinates loaded once a tile), lerps them with shuffles
//             and writes the level's bf16 values into A, then arrives on
//             full[l];
//   consumers four warpgroups; warpgroup w multiplies A by outputs 64w ..
//             64w + 63 (wgmma m64n64k16, 32 accumulators a thread: at 1024
//             threads ptxas compiles every thread to 64 registers, too few
//             for m64n128's 64 accumulators): on full[l] the k-steps that
//             read only levels <= l (5l .. 5l + 4, the last to 20), then
//             arrive on empty[l]; after step 3, bias + relu from the
//             accumulators, stored as whole 32-byte sectors.
// A level l of the next tile waits on empty[min(l + 1, 3)], the last step
// that reads its k-steps, so the gather of a tile overlaps the products
// and the epilogue of the one before, and no barrier stops the block.
// (Measured on an H100, 700 W, a RAFT iteration: 0.092 ms; without the
// products and the stores 0.081, without the tap loads 0.068, so most of
// it is the gather's instructions (kernel_variants.py k1). Not kept:
// all 8 warps of two m64n128 warpgroups gathering every level between
// block barriers, 0.187 ms (chip_smoke.py); 8 producer warps, 0.148 ms
// (48 bytes spilled at 768 threads' 80 registers); the producers' level
// loop unrolled, which spills 212 bytes of A's store addresses, 0.119
// ms; the next level's taps loaded before the current level's lerps,
// 0.099 ms (kernel_variants.py k1). Two m64n128 consumer warpgroups
// beside 16 producer warps do not compile: 768 threads leave ptxas 80
// registers a thread.)
//
// Over a bf16 volume with fp32 parameters (corr_lookup_moenc_bf16_volume;
// the JAX RAFT refining in fp32 over its bf16 volume). Semantics:
// propainter_tpu_torch/ops/corr.py:corr_lookup_moenc_bf16_volume. The TPU
// kernel casts convc1's parameters to fp32 and rounds the weight to bf16
// for the product (corr_pallas.py:296-303, 393-394), so this is the bf16
// form's kernel with the weight rounded by the wrapper and an fp32 bias
// (the kernel's bias type is a template parameter).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "bf16.cuh"
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

// ---- the bf16 form -------------------------------------------------------

constexpr int kBQb = 64;                        // queries per tile: wgmma's M
constexpr int kConsumerGroups = 4;              // warpgroups of 64 outputs
constexpr int kConsumerThreads = 128 * kConsumerGroups;
constexpr int kProducerWarps = 16;
constexpr int kThreadsB = kConsumerThreads + 32 * kProducerWarps;   // 1024
constexpr int kQPW = kBQb / kProducerWarps;     // queries a producer warp
static_assert(kF == 64 * kConsumerGroups && kThreadsB <= 1024,
              "a consumer warpgroup per 64 outputs");
constexpr int kKSteps = kCP / 16;               // 21 k-steps of 16
// Both operands K-major in the 32-byte swizzle: one k-step of 16 channels
// is a block of 32-byte rows (8-row groups 256 bytes apart), so K = 336
// needs no padding to a 128-byte atom and convc1's whole weight fits.
constexpr int kRowB = 32;
constexpr int kABlock = kBQb * kRowB;           // 2 KB: a k-step of A
constexpr int kWBlock = kF * kRowB;             // 8 KB: a k-step of B
constexpr int kBarBytes = 8 * 2 * kLevels;      // full[l], empty[l]
constexpr size_t kSmemB = kKSteps * (kWBlock + kABlock) + kBarBytes
                          + 1024;               // + room to align
static_assert(kSmemB <= 232448, "the weight and one A tile fit");

struct LevelsBf16 {
  const __nv_bfloat16* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

// Bias columns col, col + 1 in fp32: a bf16 bias (the bf16 form) or an
// fp32 one (over a bf16 volume with fp32 parameters).
__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* b, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + col));
}
__device__ __forceinline__ float2 bias_pair(const float* b, int col) {
  return *reinterpret_cast<const float2*>(b + col);
}

// Byte offset of 16-byte chunk c (0, 1) of row r in a block of 32-byte
// rows in the 32-byte swizzle (bit 4 of the address ^= bit 7).
__device__ __forceinline__ uint32_t swizzled32(int r, int c) {
  return r * kRowB + ((c ^ ((r >> 2) & 1)) << 4);
}

// Byte offset of A's element (query m, channel k).
__device__ __forceinline__ uint32_t a_offset(int m, int k) {
  return (k >> 4) * kABlock + swizzled32(m, (k >> 3) & 1) + (k & 7) * 2;
}

// Shared-memory matrix descriptor of a K-major operand in the 32-byte
// swizzle (layout type 3): 8-row groups 256 bytes apart (the stride byte
// offset); the leading byte offset is unused for a swizzled K-major
// operand whose k-step spans the swizzle width.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(8 * kRowB >> 4) << 32 | 3ull << 62;
}

// The first k-step of level step l and the one past its last: step l
// reads channels below 81 (l + 1) only (kStepGroups), the last to 336.
__host__ __device__ constexpr int step_begin(int l) { return kStepGroups * l; }
__host__ __device__ constexpr int step_end(int l) {
  return l + 1 < kLevels ? kStepGroups * (l + 1) : kKSteps;
}

// Query n's integer taps of level l's 10 x 10 window at (x, y) (the
// query's coordinates at the level): lane (r, c) reads rows r + 3k, k =
// 0..3, column c (zero outside the map or past the last query). Each
// level has fewer than 2^31 elements (the wrapper checks).
__device__ __forceinline__ void load_window(const LevelsBf16& lv, int l,
                                            int n, bool live, float x,
                                            float y, int r, int c,
                                            float (&gv)[4]) {
  const int H = lv.h[l], W = lv.w[l];
  // a window wholly outside the map stays wholly outside after the
  // clamp, which keeps the integer taps small
  const int xs = static_cast<int>(fminf(fmaxf(floorf(x), -6.f), W + 4.f))
                 - kRadius + c;
  const int ys = static_cast<int>(fminf(fmaxf(floorf(y), -6.f), H + 4.f))
                 - kRadius + r;
  const unsigned short* m =
      reinterpret_cast<const unsigned short*>(lv.ptr[l]);
  const int row0 = (live ? n * H : 0) + ys;
  const bool col_in = live && xs >= 0 && xs < W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = ys + 3 * k;
    const bool in = col_in && r + 3 * k < kWin && yy >= 0 && yy < H;
    gv[k] = in ? __uint_as_float(static_cast<uint32_t>(
                     __ldg(m + (row0 + 3 * k) * W + xs)) << 16)
               : 0.f;
  }
}

// The window's 81 values from its taps: rows lerped by fy in bf16 (fy
// rounded, each product and the sum rounded; the row below from lane +
// 10, or from the next load's lane c, 20 lanes down), then columns by fx
// in fp32 (the column right from lane + 1); v[k] is lane (r, c)'s value
// at column c, row 3k + r, for c < 9.
__device__ __forceinline__ void lerp_window(const float (&gv)[4], float x,
                                            float y, int r,
                                            float (&v)[3]) {
  const float fyb = bf::round_bf16(y - floorf(y));
  const float omfy = bf::round_bf16(1.f - fyb);
  const float fx = x - floorf(x);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float up = __shfl_down_sync(0xffffffffu, gv[k], kWin);
    const float wrap = __shfl_up_sync(0xffffffffu, gv[k + 1], 2 * kWin);
    const float below = r < 2 ? up : wrap;
    const float gy =
        bf::round_bf16(__fadd_rn(bf::round_bf16(__fmul_rn(gv[k], omfy)),
                                 bf::round_bf16(__fmul_rn(below, fyb))));
    const float right = __shfl_down_sync(0xffffffffu, gy, 1);
    v[k] = __fadd_rn(__fmul_rn(gy, 1.f - fx), __fmul_rn(right, fx));
  }
}

template <class Bias>
__global__ void __launch_bounds__(kThreadsB, 1)
corr_lookup_moenc_bf16_kernel(LevelsBf16 lv, const float* __restrict__ coords,
                              const __nv_bfloat16* __restrict__ weight,
                              const Bias* __restrict__ bias,
                              float* __restrict__ out, int n_query,
                              int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t w_base = base;                        // [21][256 rows]
  const uint32_t a_base = base + kKSteps * kWBlock;    // [21][64 rows]
  const uint32_t bars = a_base + kKSteps * kABlock;
  unsigned char* const a = smem_raw + (a_base - raw);
  // full[l]: level l of the tile's A written (one arrival a producer
  // warp); empty[l]: level step l's products done (one a consumer warp)
  auto full = [&](int l) { return bars + 8 * l; };
  auto empty = [&](int l) { return bars + 8 * (kLevels + l); };
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int role = wga::warpgroup();   // 0 .. 3 consumers, 4 .. 7 producers
  if (tid == 0) {
    for (int l = 0; l < kLevels; ++l) {
      wga::bar_init(full(l), kProducerWarps);
      wga::bar_init(empty(l), kConsumerThreads / 32);
    }
    wga::bar_init_fence();
  }
  __syncthreads();

  if (role >= kConsumerThreads / 128) {
    // ---- producers: warp pw gathers queries pw + 16q of each tile, level
    // by level. Tile i's level l overwrites A's k-steps that step
    // min(l + 1, 3) of tile i - 1 was the last to read.
    const int pw = warp - kConsumerThreads / 32;
    const int r = lane / kWin, c = lane % kWin;   // window row, column
    const bool glane = lane < 3 * kWin;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      float cx[kQPW], cy[kQPW];
#pragma unroll
      for (int q = 0; q < kQPW; ++q) {
        const int n = tile * kBQb + pw + kProducerWarps * q;
        const bool live = n < n_query;
        cx[q] = live ? __ldg(coords + 2 * static_cast<size_t>(n)) : 0.f;
        cy[q] = live ? __ldg(coords + 2 * static_cast<size_t>(n) + 1) : 0.f;
      }
      // (not unrolled: unrolled, the compiler keeps the 48 store addresses
      // of A across the tiles and spills them)
#pragma unroll 1
      for (int l = 0; l < kLevels; ++l) {
        const float scale = 1.f / static_cast<float>(1 << l);
        float gv[kQPW][4];
#pragma unroll
        for (int q = 0; q < kQPW; ++q) {
          const int n = tile * kBQb + pw + kProducerWarps * q;
          load_window(lv, l, n, n < n_query && glane,
                      cx[q] * scale, cy[q] * scale, r, c, gv[q]);
        }
        float v[kQPW][3];
#pragma unroll
        for (int q = 0; q < kQPW; ++q)
          lerp_window(gv[q], cx[q] * scale, cy[q] * scale, r, v[q]);
        wga::bar_wait(empty(l + 1 < kLevels ? l + 1 : l), (it + 1) & 1);
        if (glane && c < kTaps) {
#pragma unroll
          for (int q = 0; q < kQPW; ++q)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              *reinterpret_cast<__nv_bfloat16*>(
                  a + a_offset(pw + kProducerWarps * q,
                               l * kLevelC + c * kTaps + 3 * k + r)) =
                  __float2bfloat16_rn(v[q][k]);
        }
        wga::proxy_fence();   // the values visible to wgmma
        __syncwarp();
        if (lane == 0) wga::bar_arrive(full(l));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies the tile by outputs 64 wg ..
  // + 63, level step by level step, then bias + relu
  const int wg = role;
  const int g = lane / 4, t = lane % 4;
  // convc1's weight, once: row f's 16-byte chunk q (channels 8q .. 8q + 7)
  // into k-step q / 2; A's padding channels stay zero
  for (int e = tid; e < kF * (kCP / 8); e += kConsumerThreads) {
    const int f = e / (kCP / 8), q = e % (kCP / 8);
    wga::cp_async16(w_base + (q >> 1) * kWBlock + swizzled32(f, q & 1),
                    weight + f * kCP + 8 * q, true);
  }
  bf::cp_async_commit();
  for (int e = tid; e < kBQb * (kCP - kC); e += kConsumerThreads)
    *reinterpret_cast<__nv_bfloat16*>(
        a + a_offset(e / (kCP - kC), kC + e % (kCP - kC))) =
        __float2bfloat16(0.f);
  bf::cp_async_wait<0>();
  wga::proxy_fence();
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");

  const uint64_t da = desc_sw32(a_base);
  const uint64_t db = desc_sw32(w_base + wg * 64 * kRowB);
  float acc[32];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      wga::bar_wait(full(l), it & 1);
      wga::proxy_fence();
      wga::pin(acc);
      wga::wgmma_fence();
#pragma unroll
      for (int kk = step_begin(l); kk < step_end(l); ++kk)
        wga::mma_ss_n64(acc, da + kk * kABlock / 16, db + kk * kWBlock / 16,
                        kk > 0);
      wga::wgmma_commit();
      wga::wgmma_wait<0>();
      wga::pin(acc);
      __syncwarp();
      if (lane == 0) wga::bar_arrive(empty(l));
    }
    // bias + relu from the accumulators: thread (warp, g, t) of the
    // group holds rows 16 (warp % 4) + g (+ 8), columns 8j + 2t, + 1; a
    // warp's store fills whole 32-byte sectors of 8 rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = tile * kBQb + 16 * (warp % 4) + g + 8 * h;
      if (n >= n_query) continue;
      float* const row = out + static_cast<size_t>(n) * kF + 64 * wg + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = bias_pair(bias, 64 * wg + 8 * j + 2 * t);
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(fmaxf(acc[4 * j + 2 * h] + b.x, 0.f),
                        fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.f));
      }
    }
  }
}

// The bf16 form's setup, per device (as configure): more than 48 KB of
// dynamic shared memory, for both instances.
bool configured_bf16[kMaxDevices] = {};

int configure_bf16() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (configured_bf16[dev]) return 0;
  err = cudaFuncSetAttribute(
      corr_lookup_moenc_bf16_kernel<__nv_bfloat16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemB));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        corr_lookup_moenc_bf16_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemB));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured_bf16[dev] = true;
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

namespace {

// Launches K1's bf16 kernel with a bias of type Bias: `blocks` persistent
// blocks (the wrapper's ops/corr.py:k1_bf16_grid) walk the 64-query tiles.
template <class Bias>
int launch_bf16(const void* l0, const void* l1, const void* l2,
                const void* l3, const void* coords, const void* weight,
                const void* bias, void* out, int n_query, int h0, int w0,
                int h1, int w1, int h2, int w2, int h3, int w3, int blocks,
                void* stream) {
  const int err = configure_bf16();
  if (err != 0) return err;
  LevelsBf16 lv;
  lv.ptr[0] = static_cast<const __nv_bfloat16*>(l0);
  lv.ptr[1] = static_cast<const __nv_bfloat16*>(l1);
  lv.ptr[2] = static_cast<const __nv_bfloat16*>(l2);
  lv.ptr[3] = static_cast<const __nv_bfloat16*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int n_tiles = (n_query + kBQb - 1) / kBQb;
  if (blocks < 1 || blocks > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  corr_lookup_moenc_bf16_kernel<Bias><<<blocks, kThreadsB, kSmemB,
                                        static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<const Bias*>(bias), static_cast<float*>(out), n_query,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form: levels bf16, coords fp32, weight (256, 336) bf16 (convc1's
// rows, channels 324 .. 335 zero), bias (256) bf16, out (N, 256) fp32; all
// contiguous, weight and out 16-byte aligned (the wrapper checks).
extern "C" int corr_lookup_moenc_bf16(const void* l0, const void* l1,
                                      const void* l2, const void* l3,
                                      const void* coords, const void* weight,
                                      const void* bias, void* out,
                                      int n_query, int h0, int w0, int h1,
                                      int w1, int h2, int w2, int h3, int w3,
                                      int blocks, void* stream) {
  return launch_bf16<__nv_bfloat16>(l0, l1, l2, l3, coords, weight, bias,
                                    out, n_query, h0, w0, h1, w1, h2, w2, h3,
                                    w3, blocks, stream);
}

// Over a bf16 volume with fp32 parameters (the JAX RAFT's fp32 refine over
// its bf16 volume): as the bf16 form, the weight rounded to bf16 by the
// wrapper, the bias (256) fp32 and added in fp32, as the TPU kernel's
// epilogue does (corr_pallas.py:296-303, 393-394).
extern "C" int corr_lookup_moenc_bf16_volume(
    const void* l0, const void* l1, const void* l2, const void* l3,
    const void* coords, const void* weight, const void* bias, void* out,
    int n_query, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int blocks, void* stream) {
  return launch_bf16<float>(l0, l1, l2, l3, coords, weight, bias, out,
                            n_query, h0, w0, h1, w1, h2, w2, h3, w3, blocks,
                            stream);
}

// Launch facts of the bf16 forms (as corr_lookup_moenc_launch_info; the
// persistent grid is the wrapper's).
extern "C" int corr_lookup_moenc_bf16_launch_info(void* info, void*) {
  const int err = configure_bf16();
  if (err != 0) return err;
  int* i = static_cast<int*>(info);
  i[1] = static_cast<int>(kSmemB);
  i[2] = kThreadsB;
  i[3] = kBQb;
  i[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      i, corr_lookup_moenc_bf16_kernel<__nv_bfloat16>, kThreadsB, kSmemB));
}
