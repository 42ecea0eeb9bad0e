// K7: RAFT radius-4 correlation window lookup, without an epilogue.
//
// Replaces propainter_tpu/ops/corr_pallas.py:_lookup_kernel as
// corr_lookup_fused calls it without `moenc` (its pallas_call at :363): the
// form the JAX RAFT runs with corr_layout="batched". Semantics:
// propainter_tpu_torch/ops/corr.py:_corr_lookup_plain.
//
// Layout: level l of the pyramid is (N, H_l, W_l) fp32, row n = query n's
// correlation with every key pixel; coords (N, 2) pixel (x, y); out (N, 324)
// fp32, channel l*81 + i*9 + j the bilinear sample of level l at
// (x / 2^l + i - 4, y / 2^l + j - 4), zero outside the map.
//
// Design: one warp per query, and within it one pass per (query, level),
// as K1 gathers. Lane (r, c) = (lane / 10, lane % 10) reads window row
// r + 3k (k = 0..3), column c, of the level's 10 x 10 integer window (zero
// outside the map), so each neighbour is read once and a load touches
// three contiguous rows of one query's map; the four levels' 16 loads are
// all issued before the first lerp. Shuffles then lerp rows first, then
// columns, with __fmul_rn / __fadd_rn in the plain version's operation
// order, so no FMA contraction moves a value. Offsets, floors and
// fractions are computed once per (query, level); windows larger than the
// map, or wholly outside it, fall out of the per-tap range test. The 324
// values go through the warp's slice of shared memory and leave as 81
// contiguous 128-bit stores.
// Bound: bytes (the 324 fp32 outputs a query writes, and the in-range
// taps of its 4 x 100-tap windows it reads).
//
// The bf16 form (corr_lookup_bf16; the TPU kernel over a bf16 volume, as
// the JAX RAFT's batched layout runs it under precision="bf16"). Semantics:
// propainter_tpu_torch/ops/corr.py:corr_lookup_bf16. The levels are bf16,
// coords and out fp32 as above. The same warp per query, gathering bf16
// taps; the row lerp rounds where the TPU kernel rounds (fy rounded to
// bf16, each product and the sum rounded, corr_pallas.py:189-196), the
// column lerp stays fp32 (:264-265) and the value is written as fp32
// (its out_shape, :366). Bound: bytes, the taps' half of them halved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "bf16.cuh"

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

template <class T>
struct Levels {
  const T* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

__device__ __forceinline__ float tap(const float* m) { return __ldg(m); }
__device__ __forceinline__ float tap(const __nv_bfloat16* m) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(m));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Query n's 324 values into its warp's row of shared memory, then out.
template <class T>
__device__ __forceinline__ void lookup(const Levels<T>& lv,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int n,
                                       float* row) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
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
    const T* m = lv.ptr[l] + static_cast<size_t>(n) * H * W;
    const bool col_in = glane && xs >= 0 && xs < W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = ys + 3 * k;
      const bool in = col_in && r + 3 * k < kWin && yy >= 0 && yy < H;
      gv[l][k] = in ? tap(m + yy * W + xs) : 0.f;
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
    // bf16: fy and 1 - fy rounded to bf16, as the row lerp's operands
    const float fy = kBf16 ? bf::round_bf16(y - floorf(y)) : y - floorf(y);
    const float omfy = kBf16 ? bf::round_bf16(1.f - fy) : 1.f - fy;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float up = __shfl_down_sync(0xffffffffu, gv[l][k], kWin);
      const float wrap = __shfl_up_sync(0xffffffffu, gv[l][k + 1], 2 * kWin);
      const float below = r < 2 ? up : wrap;
      const float gy =
          kBf16 ? bf::round_bf16(
                      __fadd_rn(bf::round_bf16(__fmul_rn(gv[l][k], omfy)),
                                bf::round_bf16(__fmul_rn(below, fy))))
                : __fadd_rn(__fmul_rn(gv[l][k], omfy), __fmul_rn(below, fy));
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
corr_lookup_kernel(Levels<float> lv, const float* __restrict__ coords,
                   float* __restrict__ out, int n_query) {
  __shared__ __align__(16) float buf[kWarps][kC];
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_query) return;                     // whole warps leave
  lookup(lv, coords, out, n, buf[warp]);
}

__global__ void __launch_bounds__(kThreads)
corr_lookup_bf16_kernel(Levels<__nv_bfloat16> lv,
                        const float* __restrict__ coords,
                        float* __restrict__ out, int n_query) {
  __shared__ __align__(16) float buf[kWarps][kC];
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_query) return;                     // whole warps leave
  lookup(lv, coords, out, n, buf[warp]);
}

template <class T, class Kernel>
int launch(Kernel kernel, const void* l0, const void* l1, const void* l2,
           const void* l3, const void* coords, void* out, int n_query,
           int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
           void* stream) {
  if (n_query < 1) return static_cast<int>(cudaErrorInvalidValue);
  Levels<T> lv;
  lv.ptr[0] = static_cast<const T*>(l0);
  lv.ptr[1] = static_cast<const T*>(l1);
  lv.ptr[2] = static_cast<const T*>(l2);
  lv.ptr[3] = static_cast<const T*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  const int blocks = (n_query + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out),
      n_query);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out 16-byte aligned (a fresh allocation); one warp per query.
extern "C" int corr_lookup(const void* l0, const void* l1, const void* l2,
                           const void* l3, const void* coords, void* out,
                           int n_query, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, void* stream) {
  return launch<float>(corr_lookup_kernel, l0, l1, l2, l3, coords, out,
                       n_query, h0, w0, h1, w1, h2, w2, h3, w3, stream);
}

// The bf16 form: the levels bf16, coords and out as above.
extern "C" int corr_lookup_bf16(const void* l0, const void* l1,
                                const void* l2, const void* l3,
                                const void* coords, void* out, int n_query,
                                int h0, int w0, int h1, int w1, int h2,
                                int w2, int h3, int w3, void* stream) {
  return launch<__nv_bfloat16>(corr_lookup_bf16_kernel, l0, l1, l2, l3,
                               coords, out, n_query, h0, w0, h1, w1, h2, w2,
                               h3, w3, stream);
}
