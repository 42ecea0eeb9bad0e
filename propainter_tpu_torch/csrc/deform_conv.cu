// K3: modulated deformable convolution (DCNv2), 3x3, stride/pad/dilation 1,
// and K6: the same bilinear sampling without the contraction.
//
// K3 replaces propainter_tpu/ops/deform_pallas.py:_kernel_out, K6
// propainter_tpu/ops/deform_pallas.py:_kernel. Semantics:
// propainter_tpu_torch/ops/deform.py:modulated_deform_conv2d and
// deform_sample. Both sample bilinearly with zeros outside the image: each
// corner outside [0, H-1] x [0, W-1] weighs 0 (its address is clamped into
// the image), then the sum is scaled by the modulation mask.
//
// K3 layout (all fp32, contiguous): x (B, H, W, C); offset (B, H, W, dg, 9,
// 2) as (dy, dx); mask (B, H, W, dg, 9); weight (9, C, 128) = HWIO; bias
// (128); out (B, H, W, 128). C % 32 == 0, Cg = C / dg in {4, 8, 16, 32}.
//
// K3 design: a GEMM of M = B*H*W positions, N = 128 outputs and K = 9*C
// (tap-major: row k*C + c of the weight) on the tensor cores in 3xTF32
// (tf32_mma.cuh), whose A operand, the modulated bilinear samples, is
// built in shared memory and never reaches device memory (as in the TPU
// kernel). A block of 4 warps owns 64 positions x 128 outputs (warp (wm,
// wn): 32 positions x 64 outputs, 64 fp32 accumulators a thread) and walks
// K in 32-channel chunks of one tap. Per chunk:
//   taps     each (position, group) of the chunk gets its four clamped
//            corner offsets and four bilinear weights x mask, once, into
//            shared memory (the offset and mask loads are issued a chunk
//            ahead, under the previous chunk's products);
//   gather   the 64 x 32 A tile, each thread a 4-channel quad of a
//            position: four 128-bit corner reads of x's channel-contiguous
//            row, split big + small once here rather than by every warp;
//   weights  the 32 x 128 weight slice, through a 2-slot cp.async ring
//            issued a chunk ahead; no thread loads from device memory
//            inside the products;
//   products 4 k-steps of m16n8k8, 3 mma each (big·big, big·small,
//            small·big), the weight fragments split in registers.
// Fill. At 64 positions a block the main path has 102 (generator) and 51
// (flow completion) position tiles, under the card's 132 SMs. So the K
// chunks of a tile are split over a cluster of n_split blocks (chosen by
// the wrapper); each keeps its partial 64 x 128 sums in shared memory, and
// block r of the cluster sums rows [64r/n, 64(r+1)/n) of every
// block's part, in rank order, through distributed shared memory, adds the
// bias and stores them: one kernel, no atomics, the same result on every
// run.
// Fragment numbering (as in attention_tile.cuh): k-step 2p + h of a chunk
// has slots t, t + 4 on channels 16p + 4t + 2h and + 1, so one 128-bit
// load gives a thread its A values of two k-steps; n-tile 4q + r has column
// g on output 32q + 4g + r (of the warp's 64), so one 128-bit load gives
// it the B values of four n-tiles, and the accumulators of a row hold 8
// contiguous outputs. The weight slice lands in shared memory with the
// channel's 4 x 4 (t, e) block transposed (row 16p + 4e + t holds channel
// 16p + 4t + e) so those B loads are free of bank conflicts.
// Bound: operations, 3 x 2 * 9 * C * 128 FLOPs per position on the tensor
// cores in TF32.
//
// K6 layout (fp32, contiguous): x (B, H, W, C); sy, sx, mask (B, Ho, Wo,
// dg, K) absolute sample coordinates and modulation; out (B, Ho, Wo, dg, K,
// Cg), Cg = C / dg in {4, 8, 16, 32}. K6 design: one thread per (position,
// group, tap, 4-channel quad), consecutive threads on consecutive quads:
// the Cg / 4 threads of a tap read its coordinates and mask together, each
// reads its four corners as 128-bit loads and writes one 128-bit store, so
// the output (9x the size of x) is written coalesced. 32-bit indices; the
// batch is the grid's y, the quad count a template constant, so a thread
// divides only by K and dg. The TPU kernel builds a one-hot interpolation
// matrix per tap and contracts it on the MXU; here each value reads its
// four corners directly. Bound: bytes.
//
// The bf16 form of K3 (modulated_deform_conv2d_bf16; the TPU kernel as the
// JAX bf16 pipeline runs it). Semantics:
// propainter_tpu_torch/ops/deform.py:modulated_deform_conv2d_bf16. x,
// offset, mask, weight, bias and out are bf16, in K3's layouts. It rounds
// where the TPU kernel rounds (deform_pallas.py:192-204, 256-258, 276-280):
// each sample position (h + i - 1 + dy in fp32) to bf16; the column weights
// max(1 - |sx - col|, 0) to bf16, the row weights fp32; the value (its
// column lerp, row lerp and mask product, fp32, no FMA contraction) to
// bf16 as the A operand; the contraction one m16n8k16 bf16 pass with fp32
// accumulators over every group and tap; the sum to bf16, then + bias in
// bf16. A first, simple design: one block of 4 warps per 32 positions x
// 128 outputs (warp w: outputs 32w .. 32w + 31), K walked in 32-channel
// chunks of one tap; per chunk the taps' corners and weights, the weight
// chunk (transposed into k pairs) and the A tile are built in shared
// memory between barriers, then 2 k-steps of products. No cluster split
// and no overlap. Bound: operations (2 * 9 * C * 128 FLOPs per position
// at the bf16 tensor-core rate) or bytes, whichever is larger.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tc;

// Four corners of a bilinear sample at (sy, sx) in an H x W image: the
// offsets (pix0 + y * W + x) * C of the corners clamped into the image,
// and their weights x m, 0 for a corner outside it; corner order (y0, x0),
// (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1).
__device__ __forceinline__ void corners(float sy, float sx, float m, int H,
                                        int W, int C, int pix0, int4& off,
                                        float4& wt) {
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float fy = sy - y0, fx = sx - x0;
  int o[4];
  float w[4];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float yy = y0 + dy, xx = x0 + dx;
      const bool in = yy >= 0.f && yy <= H - 1 && xx >= 0.f && xx <= W - 1;
      const int yi = static_cast<int>(fminf(fmaxf(yy, 0.f), H - 1.f));
      const int xi = static_cast<int>(fminf(fmaxf(xx, 0.f), W - 1.f));
      o[2 * dy + dx] = (pix0 + yi * W + xi) * C;
      w[2 * dy + dx] =
          in ? (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx) * m : 0.f;
    }
  }
  off = make_int4(o[0], o[1], o[2], o[3]);
  wt = make_float4(w[0], w[1], w[2], w[3]);
}

// The 4 channels at xq of the four corners, weighted and summed.
__device__ __forceinline__ float4 sample4(const float* __restrict__ xq,
                                          const int4& off,
                                          const float4& wt) {
  const float4 v0 = __ldg(reinterpret_cast<const float4*>(xq + off.x));
  const float4 v1 = __ldg(reinterpret_cast<const float4*>(xq + off.y));
  const float4 v2 = __ldg(reinterpret_cast<const float4*>(xq + off.z));
  const float4 v3 = __ldg(reinterpret_cast<const float4*>(xq + off.w));
  return make_float4(
      wt.x * v0.x + wt.y * v1.x + wt.z * v2.x + wt.w * v3.x,
      wt.x * v0.y + wt.y * v1.y + wt.z * v2.y + wt.w * v3.y,
      wt.x * v0.z + wt.y * v1.z + wt.z * v2.z + wt.w * v3.z,
      wt.x * v0.w + wt.y * v1.w + wt.z * v2.w + wt.w * v3.w);
}

// ---- K3 ------------------------------------------------------------------

constexpr int kO = 128;             // output channels
constexpr int kBP = 64;             // positions per block
constexpr int kCK = 32;             // channels per K chunk
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 2;     // resident blocks asked for: no spills
constexpr int kMaxSplit = 8;        // blocks per cluster (portable limit)
constexpr int kLdA = kCK + 16;      // A rows: 128-bit fragment loads
constexpr int kLdW = kO + 8;        // weight rows: 128-bit B loads
constexpr int kLdP = kO + 4;        // partial-sum rows
constexpr int kAFloats = kBP * kLdA;
constexpr int kWFloats = kCK * kLdW;

template <int kCg>
constexpr size_t smem_bytes() {
  // weight ring, A big + small, then the chunk's taps (int4 + float4 per
  // (position, group)); the partial sums reuse the front at the end
  return sizeof(float) * (2 * kWFloats + 2 * kAFloats)
         + 32 * kBP * (kCK / kCg);
}
static_assert(kBP * kLdP <= 2 * kWFloats + 2 * kAFloats,
              "the partial sums fit in the ring and A tiles");

template <int kCg>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
deform_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int n_pos, int H, int W, int C, int n_split) {
  constexpr int kNG = kCK / kCg;           // groups per chunk
  constexpr int kPer = (kNG + 1) / 2;      // (position, group)s a thread
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;                            // [2][kCK][kLdW]
  float* const a_big = ring + 2 * kWFloats;            // [kBP][kLdA]
  float* const a_small = a_big + kAFloats;
  int4* const tap_off = reinterpret_cast<int4*>(a_small + kAFloats);
  float4* const tap_w = reinterpret_cast<float4*>(tap_off + kBP * kNG);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int rank = blockIdx.x % n_split;
  const int p0 = blockIdx.x / n_split * kBP;
  const int dg = C / kCg, n_cc = C / kCK, n_chunks = 9 * n_cc;
  const int j0 = n_chunks * rank / n_split;
  const int j1 = n_chunks * (rank + 1) / n_split;

  // the position whose taps this thread prepares (groups tid / kBP + 2i)
  const int pm = tid % kBP;
  const int p = p0 + pm;
  const bool live = p < n_pos;
  int h = 0, w = 0, pix0 = 0;
  if (live) {
    const int b = p / (H * W);
    const int r = p - b * H * W;
    h = r / W;
    w = r - h * W;
    pix0 = b * H * W;
  }
  float2 raw_off[kPer];
  float raw_m[kPer];

  auto load_taps = [&](int j) {
    const int k = j / n_cc;
    const int g0 = (j - k * n_cc) * kNG;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int gi = tid / kBP + 2 * i;
      raw_off[i] = make_float2(0.f, 0.f);
      raw_m[i] = 0.f;
      if (live && gi < kNG) {
        const int idx = (p * dg + g0 + gi) * 9 + k;
        raw_off[i] = __ldg(reinterpret_cast<const float2*>(offset) + idx);
        raw_m[i] = __ldg(mask + idx);
      }
    }
  };
  auto store_taps = [&](int j) {
    const int k = j / n_cc;
    const float by = static_cast<float>(h + k / 3 - 1);
    const float bx = static_cast<float>(w + k % 3 - 1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int gi = tid / kBP + 2 * i;
      if (gi >= kNG) continue;
      int4 o;
      float4 wt;
      corners(by + raw_off[i].x, bx + raw_off[i].y, raw_m[i], H, W, C, pix0,
              o, wt);
      tap_off[pm * kNG + gi] = o;
      tap_w[pm * kNG + gi] = wt;
    }
  };
  auto issue_weights = [&](int j, int slot) {
    const float* src = weight + static_cast<size_t>(j) * kCK * kO;
    float* dst = ring + slot * kWFloats;
#pragma unroll
    for (int i = 0; i < kCK * kO / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int c = e / (kO / 4), col = 4 * (e % (kO / 4));
      const int row = (c & ~15) | ((c & 3) << 2) | ((c >> 2) & 3);
      cp_async16(dst + row * kLdW + col, src + c * kO + col, true);
    }
  };
  auto gather = [&](int j) {
    const int quad = tid % 8;
    const int gi = 4 * quad / kCg;
    const float* xq = x + (j % n_cc) * kCK + 4 * quad;
#pragma unroll
    for (int i = 0; i < kBP * kCK / 4 / kThreads; ++i) {
      const int pos = tid / 8 + 16 * i;
      const float4 s = sample4(xq, tap_off[pos * kNG + gi],
                               tap_w[pos * kNG + gi]);
      uint32_t big[4], small[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) split(lane4(s, c), big[c], small[c]);
      *reinterpret_cast<uint4*>(a_big + pos * kLdA + 4 * quad) =
          make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(a_small + pos * kLdA + 4 * quad) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

  auto products = [&](int slot) {
    const float* ws = ring + slot * kWFloats + 64 * wn + 4 * g;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      float4 ab[2][2], as[2][2];   // [m-tile][rows g, g + 8]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 32 * wm + 16 * mi + 8 * hh + g;
          ab[mi][hh] = *reinterpret_cast<const float4*>(
              a_big + row * kLdA + 16 * pp + 4 * t);
          as[mi][hh] = *reinterpret_cast<const float4*>(
              a_small + row * kLdA + 16 * pp + 4 * t);
        }
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        uint32_t fb[2][4], fs[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          fb[mi][0] = __float_as_uint(lane4(ab[mi][0], 2 * hk));
          fb[mi][1] = __float_as_uint(lane4(ab[mi][1], 2 * hk));
          fb[mi][2] = __float_as_uint(lane4(ab[mi][0], 2 * hk + 1));
          fb[mi][3] = __float_as_uint(lane4(ab[mi][1], 2 * hk + 1));
          fs[mi][0] = __float_as_uint(lane4(as[mi][0], 2 * hk));
          fs[mi][1] = __float_as_uint(lane4(as[mi][1], 2 * hk));
          fs[mi][2] = __float_as_uint(lane4(as[mi][0], 2 * hk + 1));
          fs[mi][3] = __float_as_uint(lane4(as[mi][1], 2 * hk + 1));
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // slot t: channel 16pp + 4t + 2hk at row 16pp + 8hk + t; slot
          // t + 4: the next channel, 4 rows on
          const float* wr = ws + (16 * pp + 8 * hk + t) * kLdW + 32 * q;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4 * kLdW);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t b0, b0s, b1, b1s;
            split(lane4(w0, r), b0, b0s);
            split(lane4(w1, r), b1, b1s);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma3(acc[mi][4 * q + r], fb[mi], fs[mi], b0, b0s, b1, b1s);
            }
          }
        }
      }
    }
  };

  // chunk j: weights in ring slot (j - j0) % 2, issued a chunk ahead; its
  // taps prepared during chunk j - 1's products
  issue_weights(j0, 0);
  cp_async_commit();
  load_taps(j0);
  store_taps(j0);
  for (int j = j0; j < j1; ++j) {
    const int slot = (j - j0) & 1;
    __syncthreads();   // taps of j visible; A tiles and slot ^ 1 consumed
    if (j + 1 < j1) issue_weights(j + 1, slot ^ 1);
    cp_async_commit();
    gather(j);
    cp_async_wait<1>();
    __syncthreads();   // A tiles and weights of j visible; taps consumed
    if (j + 1 < j1) load_taps(j + 1);
    products(slot);
    if (j + 1 < j1) store_taps(j + 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's partial sums -> shared memory [kBP][kLdP]; each row's
  // thread holds outputs 64wn + 32q + 8t .. + 7 as n-tiles 4q + r, columns
  // 2t (+ 0..3) and 2t + 1 (+ 4..7)
  float* const part = smem;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 32 * wm + 16 * mi + 8 * hh + g;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float* dst = part + row * kLdP + 64 * wn + 32 * q + 8 * t;
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[mi][4 * q][2 * hh], acc[mi][4 * q + 1][2 * hh],
            acc[mi][4 * q + 2][2 * hh], acc[mi][4 * q + 3][2 * hh]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(
            acc[mi][4 * q][2 * hh + 1], acc[mi][4 * q + 1][2 * hh + 1],
            acc[mi][4 * q + 2][2 * hh + 1], acc[mi][4 * q + 3][2 * hh + 1]);
      }
    }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();      // every block's part written
  const int r0 = kBP * rank / n_split, r1 = kBP * (rank + 1) / n_split;
  for (int e = tid; e < (r1 - r0) * (kO / 4); e += kThreads) {
    const int row = r0 + e / (kO / 4), c4 = 4 * (e % (kO / 4));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < n_split; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + row * kLdP + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (p0 + row < n_pos) {
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c4));
      *reinterpret_cast<float4*>(out + static_cast<size_t>(p0 + row) * kO
                                 + c4) =
          make_float4(s.x + bv.x, s.y + bv.y, s.z + bv.z, s.w + bv.w);
    }
  }
  cluster.sync();      // no block leaves while another reads its part
}

// The shared-memory limit is an attribute of the kernel on one device: set
// once per device, for the device current at the call (the wrapper makes
// the tensors' device current).
constexpr int kMaxDevices = 64;

template <int kCg>
int configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(
      deform_conv_kernel<kCg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kCg>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  done[dev] = true;
  return 0;
}

template <int kCg>
int launch_conv(const float* x, const float* offset, const float* mask,
                const float* weight, const float* bias, float* out,
                int n_pos, int H, int W, int C, int split,
                cudaStream_t stream) {
  const int err = configure<kCg>();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_pos + kBP - 1) / kBP * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<kCg>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, deform_conv_kernel<kCg>, x, offset,
                                     mask, weight, bias, out, n_pos, H, W, C,
                                     split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int kCg>
int conv_info(int* info) {
  const int err = configure<kCg>();
  if (err != 0) return err;
  info[1] = static_cast<int>(smem_bytes<kCg>());
  info[2] = kThreads;
  info[3] = kBP;
  info[4] = kMaxSplit;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info, deform_conv_kernel<kCg>, kThreads, smem_bytes<kCg>()));
}

// ---- K3, bf16 form --------------------------------------------------------

constexpr int kBPb = 32;            // positions per block
constexpr int kLdAb = kCK + 8;      // bf16 per A row: 20 words, conflict-free
constexpr int kLdWb = kCK + 8;      // bf16 per transposed weight row (one o)

template <int kCg>
__global__ void __launch_bounds__(kThreads)
deform_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ offset,
                        const __nv_bfloat16* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ weight,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int n_pos, int H,
                        int W, int C) {
  constexpr int kNG = kCK / kCg;           // groups per chunk
  __shared__ __align__(16) __nv_bfloat16 a[kBPb * kLdAb];
  __shared__ __align__(16) __nv_bfloat16 wt[kO * kLdWb];
  __shared__ int4 tap_off[kBPb * kNG];
  __shared__ float4 tap_w[kBPb * kNG];     // wx0, wx1 (bf16), wy0, wy1
  __shared__ float tap_m[kBPb * kNG];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int p0 = blockIdx.x * kBPb;
  const int dg = C / kCg, n_cc = C / kCK, n_chunks = 9 * n_cc;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int j = 0; j < n_chunks; ++j) {
    const int k = j / n_cc;
    const int c0 = (j - k * n_cc) * kCK;
    __syncthreads();   // the previous chunk's products are done
    // taps of (position, group): corners clamped into the image, weights
    // zero for a corner outside it
    for (int e = tid; e < kBPb * kNG; e += kThreads) {
      const int pm = e / kNG, gi = e % kNG;
      const int p = p0 + pm;
      int4 o = make_int4(0, 0, 0, 0);
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      float m = 0.f;
      if (p < n_pos) {
        const int b = p / (H * W);
        const int rr = p - b * H * W;
        const int h = rr / W, w = rr - h * W;
        const int idx = (p * dg + c0 / kCg + gi) * 9 + k;
        const float2 d = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(offset)[idx]);
        m = __bfloat162float(mask[idx]);
        const float sy = bf::round_bf16(
            __fadd_rn(static_cast<float>(h + k / 3 - 1), d.x));
        const float sx = bf::round_bf16(
            __fadd_rn(static_cast<float>(w + k % 3 - 1), d.y));
        const float y0 = floorf(sy), x0 = floorf(sx);
        const bool yin0 = y0 >= 0.f && y0 <= H - 1;
        const bool yin1 = y0 + 1.f >= 0.f && y0 + 1.f <= H - 1;
        const bool xin0 = x0 >= 0.f && x0 <= W - 1;
        const bool xin1 = x0 + 1.f >= 0.f && x0 + 1.f <= W - 1;
        wv.x = xin0 ? bf::round_bf16(fmaxf(1.f - fabsf(sx - x0), 0.f)) : 0.f;
        wv.y = xin1 ? bf::round_bf16(fmaxf(1.f - fabsf(sx - (x0 + 1.f)), 0.f))
                    : 0.f;
        wv.z = yin0 ? fmaxf(1.f - fabsf(sy - y0), 0.f) : 0.f;
        wv.w = yin1 ? fmaxf(1.f - fabsf(sy - (y0 + 1.f)), 0.f) : 0.f;
        const int ya = static_cast<int>(fminf(fmaxf(y0, 0.f), H - 1.f));
        const int yb = static_cast<int>(fminf(fmaxf(y0 + 1.f, 0.f), H - 1.f));
        const int xa = static_cast<int>(fminf(fmaxf(x0, 0.f), W - 1.f));
        const int xb = static_cast<int>(fminf(fmaxf(x0 + 1.f, 0.f), W - 1.f));
        const int pix0 = b * H * W;
        o = make_int4((pix0 + ya * W + xa) * C, (pix0 + ya * W + xb) * C,
                      (pix0 + yb * W + xa) * C, (pix0 + yb * W + xb) * C);
      }
      tap_off[e] = o;
      tap_w[e] = wv;
      tap_m[e] = m;
    }
    // weight rows k*C + c0 .. + 31, transposed: wt[o][kk] (pairs of k)
    const __nv_bfloat16* wsrc =
        weight + (static_cast<size_t>(k) * C + c0) * kO;
#pragma unroll
    for (int i = 0; i < kCK / 2; ++i) {
      const __nv_bfloat16 lo = wsrc[(2 * i) * kO + tid];
      const __nv_bfloat16 hi = wsrc[(2 * i + 1) * kO + tid];
      __nv_bfloat162 pr;
      pr.x = lo;
      pr.y = hi;
      *reinterpret_cast<__nv_bfloat162*>(wt + tid * kLdWb + 2 * i) = pr;
    }
    __syncthreads();   // taps visible
    // A tile: thread (position, 4-channel quad)
#pragma unroll
    for (int i = 0; i < kBPb * kCK / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int pm = e / (kCK / 4), quad = e % (kCK / 4);
      const int tap = pm * kNG + 4 * quad / kCg;
      const int4 o = tap_off[tap];
      const float4 wv = tap_w[tap];
      const float m = tap_m[tap];
      const __nv_bfloat16* xq = x + c0 + 4 * quad;
      const uint2 r00 = __ldg(reinterpret_cast<const uint2*>(xq + o.x));
      const uint2 r01 = __ldg(reinterpret_cast<const uint2*>(xq + o.y));
      const uint2 r10 = __ldg(reinterpret_cast<const uint2*>(xq + o.z));
      const uint2 r11 = __ldg(reinterpret_cast<const uint2*>(xq + o.w));
      const uint32_t v00[2] = {r00.x, r00.y}, v01[2] = {r01.x, r01.y};
      const uint32_t v10[2] = {r10.x, r10.y}, v11[2] = {r11.x, r11.y};
      float v[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float a00 = e2 ? bf::hi(v00[hh]) : bf::lo(v00[hh]);
          const float a01 = e2 ? bf::hi(v01[hh]) : bf::lo(v01[hh]);
          const float a10 = e2 ? bf::hi(v10[hh]) : bf::lo(v10[hh]);
          const float a11 = e2 ? bf::hi(v11[hh]) : bf::lo(v11[hh]);
          const float t0 = __fadd_rn(__fmul_rn(a00, wv.x), __fmul_rn(a01, wv.y));
          const float t1 = __fadd_rn(__fmul_rn(a10, wv.x), __fmul_rn(a11, wv.y));
          v[2 * hh + e2] = __fmul_rn(
              __fadd_rn(__fmul_rn(t0, wv.z), __fmul_rn(t1, wv.w)), m);
        }
      }
      *reinterpret_cast<uint2*>(a + pm * kLdAb + 4 * quad) =
          make_uint2(bf::pack(v[0], v[1]), bf::pack(v[2], v[3]));
    }
    __syncthreads();   // A tile and weights visible
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
    const uint32_t* ww = reinterpret_cast<const uint32_t*>(wt);
#pragma unroll
    for (int s = 0; s < kCK / 16; ++s) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int w0 = ((16 * mi + g) * kLdAb + 16 * s) / 2 + t;
        fa[mi][0] = aw[w0];
        fa[mi][1] = aw[w0 + 4 * kLdAb];
        fa[mi][2] = aw[w0 + 4];
        fa[mi][3] = aw[w0 + 4 * kLdAb + 4];
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int wb = ((32 * warp + 8 * jn + g) * kLdWb + 16 * s) / 2 + t;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          bf::mma(acc[mi][jn], fa[mi], ww[wb], ww[wb + 4]);
      }
    }
  }

  // the sum rounded to bf16, then + bias in bf16
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = p0 + 16 * mi + 8 * hh + g;
      if (p >= n_pos) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = 32 * warp + 8 * jn + 2 * t;
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
        const float s0 = __fadd_rn(bf::round_bf16(acc[mi][jn][2 * hh]), bv.x);
        const float s1 =
            __fadd_rn(bf::round_bf16(acc[mi][jn][2 * hh + 1]), bv.y);
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(p) * kO + col) =
            __floats2bfloat162_rn(s0, s1);
      }
    }
}

template <int kCg>
int launch_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* offset,
                     const __nv_bfloat16* mask, const __nv_bfloat16* weight,
                     const __nv_bfloat16* bias, __nv_bfloat16* out, int n_pos,
                     int H, int W, int C, cudaStream_t stream) {
  deform_conv_bf16_kernel<kCg><<<(n_pos + kBPb - 1) / kBPb, kThreads, 0,
                                 stream>>>(x, offset, mask, weight, bias, out,
                                           n_pos, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <int kCg>
int conv_bf16_info(int* info) {
  info[1] = 0;
  info[2] = kThreads;
  info[3] = kBPb;
  info[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info, deform_conv_bf16_kernel<kCg>, kThreads, 0));
}

// ---- K6 ------------------------------------------------------------------

constexpr int kSampleThreads = 256;

template <int kNq>      // 4-channel quads per group
__global__ void __launch_bounds__(kSampleThreads)
deform_sample_kernel(const float* __restrict__ x,
                     const float* __restrict__ sy,
                     const float* __restrict__ sx,
                     const float* __restrict__ mask,
                     float* __restrict__ out, int H, int W, int C, int dg,
                     int K, int quads_per_batch) {
  const int e = blockIdx.x * kSampleThreads + threadIdx.x;
  if (e >= quads_per_batch) return;
  const int b = blockIdx.y;
  const int om = e / kNq;                 // (ho, wo, g, k) in the batch
  const int q = e - om * kNq;
  const int grp = static_cast<unsigned>(om) / K % dg;
  const int taps = quads_per_batch / kNq;
  const int i = b * taps + om;
  int4 off;
  float4 wt;
  corners(__ldg(sy + i), __ldg(sx + i), __ldg(mask + i), H, W, C, b * H * W,
          off, wt);
  const float4 v = sample4(x + grp * 4 * kNq + 4 * q, off, wt);
  *reinterpret_cast<float4*>(out + 4 * (b * quads_per_batch + e)) = v;
}

template <int kNq>
int launch_sample(const float* x, const float* sy, const float* sx,
                  const float* mask, float* out, int B, int H, int W, int C,
                  int dg, int K, int quads_per_batch, cudaStream_t stream) {
  const dim3 grid((quads_per_batch + kSampleThreads - 1) / kSampleThreads, B);
  deform_sample_kernel<kNq><<<grid, kSampleThreads, 0, stream>>>(
      x, sy, sx, mask, out, H, W, C, dg, K, quads_per_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Index ranges (x, offset, mask and out element counts below 2^31) are the
// wrapper's to check; a shape the kernels do not take returns
// cudaErrorInvalidValue.
extern "C" int deform_sample(const void* x, const void* sy, const void* sx,
                             const void* mask, void* out, int B, int H, int W,
                             int C, int Ho, int Wo, int dg, int K,
                             void* stream) {
  if (dg < 1 || C % dg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = C / dg;
  const int quads = Ho * Wo * dg * K * (cg / 4);
  const auto args = [&](auto launch) {
    return launch(static_cast<const float*>(x), static_cast<const float*>(sy),
                  static_cast<const float*>(sx),
                  static_cast<const float*>(mask), static_cast<float*>(out),
                  B, H, W, C, dg, K, quads,
                  static_cast<cudaStream_t>(stream));
  };
  switch (cg) {
    case 4: return args(launch_sample<1>);
    case 8: return args(launch_sample<2>);
    case 16: return args(launch_sample<4>);
    case 32: return args(launch_sample<8>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int modulated_deform_conv2d(const void* x, const void* offset,
                                       const void* mask, const void* weight,
                                       const void* bias, void* out, int B,
                                       int H, int W, int C, int dg, int split,
                                       void* stream) {
  if (dg < 1 || C % dg != 0 || C % kCK != 0 || split < 1
      || split > kMaxSplit || split > 9 * C / kCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto launch) {
    return launch(static_cast<const float*>(x),
                  static_cast<const float*>(offset),
                  static_cast<const float*>(mask),
                  static_cast<const float*>(weight),
                  static_cast<const float*>(bias), static_cast<float*>(out),
                  B * H * W, H, W, C, split,
                  static_cast<cudaStream_t>(stream));
  };
  switch (C / dg) {
    case 4: return args(launch_conv<4>);
    case 8: return args(launch_conv<8>);
    case 16: return args(launch_conv<16>);
    case 32: return args(launch_conv<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch facts for chip_smoke.py's build phase: info = {resident blocks
// per SM, dynamic shared memory bytes, threads per block, positions per
// block, most blocks per cluster} of the instance for group width cg.
extern "C" int modulated_deform_conv2d_launch_info(void* info, int cg,
                                                   void*) {
  int* i = static_cast<int*>(info);
  switch (cg) {
    case 4: return conv_info<4>(i);
    case 8: return conv_info<8>(i);
    case 16: return conv_info<16>(i);
    case 32: return conv_info<32>(i);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 form of K3: every tensor bf16, in K3's layouts; no cluster
// split.
extern "C" int modulated_deform_conv2d_bf16(const void* x, const void* offset,
                                            const void* mask,
                                            const void* weight,
                                            const void* bias, void* out,
                                            int B, int H, int W, int C,
                                            int dg, void* stream) {
  if (dg < 1 || C % dg != 0 || C % kCK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto launch) {
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(offset),
                  static_cast<const __nv_bfloat16*>(mask),
                  static_cast<const __nv_bfloat16*>(weight),
                  static_cast<const __nv_bfloat16*>(bias),
                  static_cast<__nv_bfloat16*>(out), B * H * W, H, W, C,
                  static_cast<cudaStream_t>(stream));
  };
  switch (C / dg) {
    case 4: return args(launch_conv_bf16<4>);
    case 8: return args(launch_conv_bf16<8>);
    case 16: return args(launch_conv_bf16<16>);
    case 32: return args(launch_conv_bf16<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch facts of K3's bf16 form for group width cg (as
// modulated_deform_conv2d_launch_info).
extern "C" int modulated_deform_conv2d_bf16_launch_info(void* info, int cg,
                                                        void*) {
  int* i = static_cast<int*>(info);
  switch (cg) {
    case 4: return conv_bf16_info<4>(i);
    case 8: return conv_bf16_info<8>(i);
    case 16: return conv_bf16_info<16>(i);
    case 32: return conv_bf16_info<32>(i);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
