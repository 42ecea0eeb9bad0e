// K7: RAFT radius-4 correlation window lookup, without an epilogue.
//
// Replaces propainter_tpu/ops/corr_pallas.py:_lookup_kernel as
// corr_lookup_fused calls it without `moenc` (its pallas_call at :363): the
// form the JAX RAFT runs with corr_layout="batched". Semantics:
// propainter_tpu_torch/ops/corr.py:_corr_lookup_plain.
//
// Layout: level l of the pyramid is (N, H_l, W_l), row n = query n's
// correlation with every key pixel; coords (N, 2) pixel (x, y); out (N, 324)
// fp32, channel l*81 + i*9 + j the bilinear sample of level l at
// (x / 2^l + i - 4, y / 2^l + j - 4), zero outside the map.
//
// The fp32 form (corr_lookup, fp32 levels). Design: one warp per query,
// and within it one pass per (query, level), as K1 gathers. Lane (r, c) =
// (lane / 10, lane % 10) reads window row r + 3k (k = 0..3), column c, of
// the level's 10 x 10 integer window (zero outside the map), so each
// neighbour is read once and a load touches three contiguous rows of one
// query's map; the four levels' 16 loads are all issued before the first
// lerp. Shuffles then lerp rows first, then columns, with __fmul_rn /
// __fadd_rn in the plain version's operation order, so no FMA contraction
// moves a value. Offsets, floors and fractions are computed once per
// (query, level); windows larger than the map, or wholly outside it, fall
// out of the per-tap range test. The 324 values go through the warp's
// slice of shared memory and leave as 81 contiguous 128-bit stores.
// Bound: bytes (the 324 fp32 outputs a query writes, and the in-range
// taps of its 4 x 100-tap windows it reads).
//
// The bf16 form (corr_lookup_bf16, bf16 levels; the TPU kernel over a bf16
// volume, as the JAX RAFT's batched layout runs it under precision="bf16").
// The row lerp rounds where the TPU kernel rounds (fy and 1 - fy rounded to
// bf16, each product and the sum rounded, corr_pallas.py:224-227), the
// column lerp is fp32 (:264-265) and the values are written as fp32 (its
// out_shape, :366).
// Bound: bytes. Counted, each in-range tap read once (2 B), the coords and
// the 1296 fp32 bytes a query writes: 0.0203 ms at one RAFT iteration of
// the main path. Device memory moves 32-byte sectors, and a window row is
// 20 bytes inside map rows of 108 / 54 / 26 / 12 bytes: the sectors that
// the window rows touch are 2.4 x the taps, a floor of 0.028 ms
// (chip_smoke.py's sector floor, _sector_bytes). Padding the levels to
// 16-byte rows would change K2's layout, which K1 reads too; for the same
// reason no TMA tensor map can describe a level (its row strides are not
// multiples of 16 bytes).
// Design. The earlier body, a bf16 instance of the fp32 kernel, ran each
// query's loads, shuffles, lerps and stores one after another with the
// bf16 rounding emulated in fp32 (0.045 ms on an H100; the gather alone
// 0.020, the lerps and stores each about 0.01 more; PERF.md).
// - Persistent blocks, one wave on the card (corr_lookup_bf16_launch_info),
//   each walking a contiguous run of queries in rounds of one query a
//   warp. The round count is the block's, so no branch around a shuffle
//   diverges (a warp walking its own run made the compiler guard each
//   shuffle with warp syncs, and ran slower).
// - The taps of a warp's next query load into a second register set while
//   this query's lerps run. Lane (r, c) reads tap (r + 3k, c) of each
//   level's 10 x 10 window (k = 0..3), two bytes through L1, so each
//   neighbour is read once and a load of the warp touches three rows of
//   one map; an element offset from the query's map keeps a tap's address
//   to one wide multiply-add.
// - The row lerp in bf16 with __hmul_rn / __hadd_rn (round to nearest, no
//   contraction: a bf16 x bf16 product is exact in fp32, and the fp32 sum
//   of two bf16 values is exact or the smaller lies under half a bf16 ulp
//   of the larger, so both round as the plain version's fp32 ops then bf16
//   do; the compiler pairs (tap, tap below) x (1 - fy, fy) in one bf16x2
//   product), the row below by shuffle; the column lerp in fp32 with
//   __fmul_rn / __fadd_rn in the plain version's order, gy (1 - fx) +
//   right fx.
// - A query's 324 values are staged in shared memory (two rows a warp) and
//   leave as one 1296-byte cp.async.bulk store. Its cost in code: every
//   lane's proxy fence before the store, and lane 0 waiting for the store
//   of two queries ago before a row is written again. Plain float4 stores
//   need neither and take 0.044 ms against 0.042 (kernel_variants.py k7,
//   "float4 stores"): the bulk store stays for those 3-5%.
// What bounds it, taken apart by kernel_variants.py k7 on an H100: the
// gather alone takes 0.023 ms, the lerps alone 0.028, and PyTorch's fill_
// of the 50 MB output 0.017; the kernel's 0.042 ms is near the gather plus
// the output's writes, which share the memory (the window rows touch 58 MB
// of 64-byte blocks, 3.3 x the taps). Lost on the card (kernel_variants.py
// k7): 5 blocks per SM (it spills), 4 warps a block, a run per warp,
// streaming (ld.global.cs) tap loads, each 0.044 ms. Lost too, and not
// kept as code (PERF.md has the times): a ring of 16-byte cp.async chunks
// (the aligned chunks that hold each window row, found by absolute
// element index, in two or three query stages a warp, bf16x2 row lerps
// from shared memory), 0.047 ms, and that ring fed by one cp.async.bulk
// copy a window row, 0.067 ms issued by the lanes, 0.127 by one lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;
constexpr int kTaps = 2 * kRadius + 1;          // 9
constexpr int kWin = kTaps + 1;                 // 10 integer taps a side
constexpr int kLevels = 4;
constexpr int kLevelC = kTaps * kTaps;          // 81
constexpr int kC = kLevels * kLevelC;           // 324
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kC % 4 == 0, "a query's output is whole 128-bit words");

struct Levels {
  const float* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

// ---- the fp32 form -------------------------------------------------------

// Query n's 324 values into its warp's row of shared memory, then out.
__device__ __forceinline__ void lookup(const Levels& lv,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int n,
                                       float* row) {
  const int lane = threadIdx.x % 32;
  const int r = lane / kWin, c = lane % kWin;   // window row, column
  const bool glane = lane < 3 * kWin;
  const float cx = __ldg(coords + 2 * static_cast<size_t>(n));
  const float cy = __ldg(coords + 2 * static_cast<size_t>(n) + 1);
  // lane (r, c)'s integer taps of each level's window: rows r + 3k
  float gv[kLevels][4];
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const float scale = 1.f / static_cast<float>(1 << l);
    const float x = cx * scale, y = cy * scale;
    // a window wholly outside the map stays wholly outside after the
    // clamp, which keeps the integer taps small
    const int xs = static_cast<int>(fminf(fmaxf(floorf(x), -6.f), W + 4.f))
                   - kRadius + c;
    const int ys = static_cast<int>(fminf(fmaxf(floorf(y), -6.f), H + 4.f))
                   - kRadius + r;
    const float* m = lv.ptr[l] + static_cast<size_t>(n) * H * W;
    const bool col_in = glane && xs >= 0 && xs < W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = ys + 3 * k;
      const bool in = col_in && r + 3 * k < kWin && yy >= 0 && yy < H;
      gv[l][k] = in ? __ldg(m + yy * W + xs) : 0.f;
    }
  }
  // rows lerped by fy (the row below from lane + 10, or from the next
  // load's lane c, 20 lanes down), then columns by fx (the column right
  // from lane + 1); channel l*81 + c*9 + row
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const float scale = 1.f / static_cast<float>(1 << l);
    const float x = cx * scale, y = cy * scale;
    const float fx = x - floorf(x);
    const float fy = y - floorf(y);
    const float omfy = 1.f - fy;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float up = __shfl_down_sync(0xffffffffu, gv[l][k], kWin);
      const float wrap = __shfl_up_sync(0xffffffffu, gv[l][k + 1], 2 * kWin);
      const float below = r < 2 ? up : wrap;
      const float gy =
          __fadd_rn(__fmul_rn(gv[l][k], omfy), __fmul_rn(below, fy));
      const float right = __shfl_down_sync(0xffffffffu, gy, 1);
      const float v = __fadd_rn(__fmul_rn(gy, 1.f - fx),
                                __fmul_rn(right, fx));
      if (glane && c < kTaps) row[l * kLevelC + c * kTaps + 3 * k + r] = v;
    }
  }
  __syncwarp();
  float4* const dst = reinterpret_cast<float4*>(out + static_cast<size_t>(n)
                                                * kC);
  const float4* const src = reinterpret_cast<const float4*>(row);
  for (int i = lane; i < kC / 4; i += 32) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, int n_query) {
  __shared__ __align__(16) float buf[kWarps][kC];
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_query) return;                     // whole warps leave
  lookup(lv, coords, out, n, buf[warp]);
}

// ---- the bf16 form -------------------------------------------------------

constexpr int kWarpsB = 8;
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kOutBytes = kC * 4;               // 1296: 81 x 16
constexpr int kWarpBytes = 2 * kOutBytes;       // two output rows
constexpr int kSmemB = kWarpsB * kWarpBytes;
constexpr int kMaxDevices = 64;

struct LevelsBf16 {
  const unsigned short* ptr[kLevels];           // bf16 bits
  int h[kLevels];
  int w[kLevels];
};

// The window's first column and row at level l (the clamped floors of x
// and y minus the radius, as the plain version takes them), and x, y.
struct Window {
  int xs, ys;
  float x, y;
};

__device__ __forceinline__ Window window(float cx, float cy, int l, int H,
                                         int W) {
  const float scale = 1.f / static_cast<float>(1 << l);
  const float x = cx * scale, y = cy * scale;
  // a window wholly outside the map stays wholly outside after the clamp
  return {static_cast<int>(fminf(fmaxf(floorf(x), -6.f), W + 4.f)) - kRadius,
          static_cast<int>(fminf(fmaxf(floorf(y), -6.f), H + 4.f)) - kRadius,
          x, y};
}

// Issues the loads of query n's taps: lane (r, c) = (lane / 10, lane % 10),
// lanes 0-29, takes tap (r + 3k, c) of each level's 10 x 10 integer window
// (k = 0..3; rows 10 and 11 and lanes 30-31 are zero), the bf16 bits in
// the low half, zero outside the map and everywhere if !live.
__device__ __forceinline__ void load(const LevelsBf16& lv,
                                     const float* __restrict__ coords, int n,
                                     bool live, int lane,
                                     uint32_t (&t)[kLevels][4]) {
  const int r = lane / kWin, c = lane % kWin;
  const float cx = __ldg(coords + 2 * static_cast<size_t>(n));
  const float cy = __ldg(coords + 2 * static_cast<size_t>(n) + 1);
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const Window w = window(cx, cy, l, H, W);
    const int xs = w.xs + c, ys = w.ys + r;
    const bool col_in = live && lane < 3 * kWin &&
                        static_cast<unsigned>(xs) < static_cast<unsigned>(W);
    // the query's map, and the lane's taps as element offsets into it
    // (only in-range taps, whose offsets are not negative, are read)
    const unsigned short* m = lv.ptr[l] + static_cast<size_t>(n) * (H * W);
    int off = ys * W + xs;
#pragma unroll
    for (int k = 0; k < 4; ++k, off += 3 * W) {
      const bool in = col_in && r + 3 * k < kWin &&
                      static_cast<unsigned>(ys + 3 * k) <
                          static_cast<unsigned>(H);
      t[l][k] = in ? __ldg(m + static_cast<unsigned>(off)) : 0u;
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 as_bf16(uint32_t bits) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits));
}

// Query n's 324 values from its taps into `o` (shared memory, fp32): rows
// lerped in bf16 (the row below from lane + 10, or from the next load's
// lane c, 20 lanes down), then columns in fp32 (the column right from lane
// + 1); channel l*81 + c*9 + row.
__device__ __forceinline__ void lerp(const LevelsBf16& lv,
                                     const float* __restrict__ coords, int n,
                                     const uint32_t (&t)[kLevels][4],
                                     float* o, int lane) {
  const int r = lane / kWin, c = lane % kWin;
  const float cx = __ldg(coords + 2 * static_cast<size_t>(n));
  const float cy = __ldg(coords + 2 * static_cast<size_t>(n) + 1);
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const Window w = window(cx, cy, l, lv.h[l], lv.w[l]);
    const float fx = w.x - floorf(w.x), omfx = 1.f - fx;
    const __nv_bfloat16 fy = __float2bfloat16_rn(w.y - floorf(w.y));
    const __nv_bfloat16 omfy =
        __float2bfloat16_rn(1.f - __bfloat162float(fy));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t up = __shfl_down_sync(0xffffffffu, t[l][k], kWin);
      const uint32_t wrap =
          __shfl_up_sync(0xffffffffu, t[l][k + 1], 2 * kWin);
      const __nv_bfloat16 gy =
          __hadd_rn(__hmul_rn(as_bf16(t[l][k]), omfy),
                    __hmul_rn(as_bf16(r < 2 ? up : wrap), fy));
      const float g = __bfloat162float(gy);
      const float right = __shfl_down_sync(0xffffffffu, g, 1);
      const float v = __fadd_rn(__fmul_rn(g, omfx), __fmul_rn(right, fx));
      if (lane < 3 * kWin && c < kTaps)
        o[l * kLevelC + c * kTaps + 3 * k + r] = v;
    }
  }
}

// Query q's values: lerped into output row `o`, then, if live, one bulk
// store.
__device__ __forceinline__ void finish(const LevelsBf16& lv,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int q,
                                       bool live,
                                       const uint32_t (&t)[kLevels][4],
                                       float* o, int lane) {
  // the bulk store of two queries ago has read this output row
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
  __syncwarp();
  lerp(lv, coords, q, t, o, lane);
  // the values written here are read by the bulk copy (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if (lane == 0 && live) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            out + static_cast<size_t>(q) * kC),
        "r"(static_cast<uint32_t>(__cvta_generic_to_shared(o))),
        "r"(kOutBytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

__global__ void __launch_bounds__(kThreadsB, 4)
corr_lookup_bf16_kernel(LevelsBf16 lv, const float* __restrict__ coords,
                        float* __restrict__ out, int n_query) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const o = reinterpret_cast<float*>(smem + warp * kWarpBytes);
  // the block's contiguous run of queries, walked in rounds of one query a
  // warp; the round count is the same for the block's warps, so no branch
  // around the shuffles diverges
  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  n_query / gridDim.x);
  const int b1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  n_query / gridDim.x);
  const int rounds = (b1 - b0 + kWarpsB - 1) / kWarpsB;
  // two sets of taps in registers: the next round's loads are in flight
  // while this one's lerps run
  uint32_t ta[kLevels][4], tb[kLevels][4];
  // round i's query of this warp (the block's last one past the run's
  // end, its taps zero and its values not stored)
  const auto query = [&](int i) {
    return min(b0 + i * kWarpsB + warp, b1 - 1);
  };
  const auto live = [&](int i) { return b0 + i * kWarpsB + warp < b1; };
  load(lv, coords, query(0), live(0), lane, ta);
  for (int i = 0; i < rounds; i += 2) {
    if (i + 1 < rounds) load(lv, coords, query(i + 1), live(i + 1), lane, tb);
    finish(lv, coords, out, query(i), live(i), ta, o, lane);
    if (i + 1 < rounds) {
      if (i + 2 < rounds)
        load(lv, coords, query(i + 2), live(i + 2), lane, ta);
      finish(lv, coords, out, query(i + 1), live(i + 1), tb, o + kC, lane);
    }
  }
  // shared memory must outlive the last bulk stores' reads
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The persistent grid of the bf16 form on the current device: SMs x
// resident blocks per SM, found once per device.
int slots_bf16[kMaxDevices] = {};

int configure_bf16(int& slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (slots_bf16[dev] == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, corr_lookup_bf16_kernel, kThreadsB, kSmemB);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots_bf16[dev] = n_sm * per_sm;
  }
  slots = slots_bf16[dev];
  return 0;
}

}  // namespace

// out 16-byte aligned (a fresh allocation); one warp per query.
extern "C" int corr_lookup(const void* l0, const void* l1, const void* l2,
                           const void* l3, const void* coords, void* out,
                           int n_query, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, void* stream) {
  if (n_query < 1) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.ptr[0] = static_cast<const float*>(l0);
  lv.ptr[1] = static_cast<const float*>(l1);
  lv.ptr[2] = static_cast<const float*>(l2);
  lv.ptr[3] = static_cast<const float*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int blocks = (n_query + kWarps - 1) / kWarps;
  corr_lookup_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out),
      n_query);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: the levels bf16, coords and out as above (out 16-byte
// aligned for the bulk stores); min(SMs x resident blocks, one block per 8
// queries) persistent blocks.
extern "C" int corr_lookup_bf16(const void* l0, const void* l1,
                                const void* l2, const void* l3,
                                const void* coords, void* out, int n_query,
                                int h0, int w0, int h1, int w1, int h2,
                                int w2, int h3, int w3, void* stream) {
  if (n_query < 1) return static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  const int err = configure_bf16(slots);
  if (err != 0) return err;
  LevelsBf16 lv;
  const void* ptrs[kLevels] = {l0, l1, l2, l3};
  const int hs[kLevels] = {h0, h1, h2, h3}, wd[kLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kLevels; ++l) {
    lv.ptr[l] = static_cast<const unsigned short*>(ptrs[l]);
    lv.h[l] = hs[l];
    lv.w[l] = wd[l];
  }
  const int blocks = min(slots, (n_query + kWarpsB - 1) / kWarpsB);
  corr_lookup_bf16_kernel<<<blocks, kThreadsB, kSmemB,
                            static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out),
      n_query);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the bf16 form on the current device: {resident blocks
// per SM, dynamic shared memory bytes, threads per block, queries in flight
// a warp, SMs x resident blocks (the persistent grid's most blocks)}.
extern "C" int corr_lookup_bf16_launch_info(void* info, void*) {
  int slots = 0;
  const int err = configure_bf16(slots);
  if (err != 0) return err;
  int* i = static_cast<int*>(info);
  i[1] = kSmemB;
  i[2] = kThreadsB;
  i[3] = 2;
  i[4] = slots;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      i, corr_lookup_bf16_kernel, kThreadsB, kSmemB));
}
