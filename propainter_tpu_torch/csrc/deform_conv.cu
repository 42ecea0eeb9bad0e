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
// offset, mask, weight, bias and out are bf16, in K3's layouts; C % 64 ==
// 0. It rounds where the TPU kernel rounds (deform_pallas.py:192-204,
// 256-258, 276-280): each sample position (h + i - 1 + dy in fp32) to
// bf16; the column weights max(1 - |sx - col|, 0) to bf16, the row weights
// fp32; the value (its column lerp, row lerp and mask product, fp32, no
// FMA contraction) to bf16 as the A operand; the contraction bf16 x bf16
// with fp32 sums over every group and tap (the TPU kernel sums its groups
// in fp32 across its grid, :206-211, so any fp32 order is its order); the
// sum to bf16, then + bias in bf16.
// Bound: at the main path's shapes the products (2 * 9 * C * 128 FLOPs a
// position) take 1.9 us at the bf16 tensor-core rate and the bytes 1.8-2.8
// us, so the kernel is bound by neither but by the latency of its
// gathers: each 64-channel chunk of one tap needs the taps' offsets, then
// four dependent corner reads per 8 channels.
// Design: a GEMM of M = B*H*W positions, N = 128, K = 9*C (tap-major)
// whose A operand is built in shared memory. A block is one warpgroup
// owning a 64-position x 128-output tile, 64 fp32 accumulators a thread,
// on wgmma m64n128k16 (4 per chunk). K is walked in 64-channel chunks of
// one tap through 3 stages of shared memory, each an A tile (64 rows of
// 128 bytes) and the chunk's 64 weight rows (two 64-output atoms), both in
// the 128-byte swizzle that wgmma reads: A K-major, the HWIO weight as it
// lies, MN-major (wgmma's transposed B). Per chunk every thread loads the
// next chunk's raw taps, then gathers its items of this chunk (an item:
// one position's 8 channels, 4 for group width 4: corners and weights
// from the taps, four 16-byte corner reads, the rounded values, one
// swizzled store), waits for the chunk's weight rows (cp.async issued a
// chunk ahead), passes one barrier and issues the products, which run
// under the next chunk's gather; 3 stages let one barrier a chunk order
// every reuse of a stage. Fill: at 64 positions a tile the main path has
// 102 (generator) and 51 (flow completion) tiles for 132 SMs, so each
// tile's chunks are split over a cluster of n_split blocks
// (ops/deform.py:k3_split over 64-channel chunks), whose fp32 partial sums
// meet in distributed shared memory in rank order, then are rounded and
// biased once (as the fp32 form does). At 2 resident blocks per SM (195
// to 222 registers) the split is 2 at the generator and 4 at the flow
// completion: 204 blocks of 9 chunks each, one round.
// (Measured on an H100, 700 W, and not kept: 3 resident blocks per SM,
// ptxas held to 168 registers, split 3 / 6, 0.041 / 0.030 ms against
// 0.036 / 0.030; a fourth stage, no change (kernel_variants.py k3). The
// form this replaces, one block of 4 warps per 32 positions walking every
// chunk on mma.sync between three barriers a chunk, is in PERF.md.)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "bf16.cuh"
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

template <class Kernel>
int configure(Kernel kernel, size_t smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  done[dev] = true;
  return 0;
}

// One launch of `kernel` over `tiles` position tiles, each split over a
// cluster of `split` blocks.
template <class Kernel, class... Args>
int launch_split(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
                 int threads, int tiles, int split, cudaStream_t stream,
                 Args... args) {
  const int err = configure(kernel, smem, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// info = {resident blocks per SM, dynamic shared memory bytes, threads per
// block, positions per block, most blocks per cluster}.
template <class Kernel>
int split_info(Kernel kernel, bool (&done)[kMaxDevices], size_t smem,
               int threads, int positions, int* info) {
  const int err = configure(kernel, smem, done);
  if (err != 0) return err;
  info[1] = static_cast<int>(smem);
  info[2] = threads;
  info[3] = positions;
  info[4] = kMaxSplit;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info, kernel, threads, smem));
}

template <int kCg>
bool conv_configured[kMaxDevices] = {};

template <int kCg>
int launch_conv(const float* x, const float* offset, const float* mask,
                const float* weight, const float* bias, float* out,
                int n_pos, int H, int W, int C, int split,
                cudaStream_t stream) {
  return launch_split(deform_conv_kernel<kCg>, conv_configured<kCg>,
                      smem_bytes<kCg>(), kThreads, (n_pos + kBP - 1) / kBP,
                      split, stream, x, offset, mask, weight, bias, out,
                      n_pos, H, W, C, split);
}

template <int kCg>
int conv_info(int* info) {
  return split_info(deform_conv_kernel<kCg>, conv_configured<kCg>,
                    smem_bytes<kCg>(), kThreads, kBP, info);
}

// ---- K3, bf16 form --------------------------------------------------------

constexpr int kBPb = 64;            // positions per tile: wgmma's M
constexpr int kCKb = 64;            // channels per K chunk: one 128-byte
                                    // swizzled row of bf16
constexpr int kStagesB = 3;         // A + weight stages
constexpr int kBlocksPerSmB = 2;    // resident blocks asked for: no spills
constexpr int kAStageB = kBPb * kCKb * 2;              // 8 KB, one atom
constexpr int kWAtomB = kCKb * wga::kAtomRow;          // 64 k x 64 outputs
constexpr int kStageB = kAStageB + 2 * kWAtomB;        // 24 KB
constexpr int kLdPb = kO + 8;       // partial-sum row (floats): float2
                                    // stores free of bank conflicts
constexpr size_t kSmemB = kStagesB * kStageB + 1024;   // + room to align
static_assert(kBPb * kLdPb * sizeof(float) <= kStagesB * kStageB,
              "the partial sums fit in the stages");

#define K3B_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define K3B_F16(a, i) \
  K3B_F4(a, i), K3B_F4(a, i + 4), K3B_F4(a, i + 8), K3B_F4(a, i + 12)

// d += A·B over one k-step of 16: A 64 x 16 K-major, B 16 (k) x 128 (n)
// MN-major (tnspB 1: the HWIO weight's own layout), both in shared memory
// in the 128-byte swizzle.
__device__ __forceinline__ void mma_ss_n128_mn(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 1;\n}"
      : K3B_F16(d, 0), K3B_F16(d, 16), K3B_F16(d, 32), K3B_F16(d, 48)
      : "l"(da), "l"(db), "r"(1));
}

#undef K3B_F16
#undef K3B_F4

// Word e of a 16-byte load (e a constant once the loops are unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// kU channels (8, or 4 for group width 4) at p of x: kU / 2 words.
template <int kU>
__device__ __forceinline__ uint4 load_channels(const __nv_bfloat16* p) {
  if constexpr (kU == 8) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(v.x, v.y, 0u, 0u);
  }
}

template <int kCg>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmB)
deform_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ offset,
                        const __nv_bfloat16* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ weight,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int n_pos, int H,
                        int W, int C, int n_split) {
  constexpr int kU = kCg < 8 ? kCg : 8;          // channels an item
  constexpr int kUnits = kCKb / kU;              // items a position row
  constexpr int kRowsPass = kThreads / kUnits;   // rows of one pass
  constexpr int kItems = kBPb / kRowsPass;       // items a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  unsigned char* const smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.x % n_split;
  const int p0 = blockIdx.x / n_split * kBPb;
  const int dg = C / kCg, n_cc = C / kCKb, n_chunks = 9 * n_cc;
  const int j0 = n_chunks * rank / n_split;
  const int j1 = n_chunks * (rank + 1) / n_split;
  const int unit = tid % kUnits, row0 = tid / kUnits;

  // item i: tile row row0 + kRowsPass i, channels unit kU .. + kU - 1 of
  // each chunk; ih < 0 past the last position
  int ih[kItems], iw[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = p0 + row0 + kRowsPass * i;
    ih[i] = -1;
    iw[i] = 0;
    if (p < n_pos) {
      const int r = p % (H * W);
      ih[i] = r / W;
      iw[i] = r - ih[i] * W;
    }
  }

  // the raw taps (dy, dx as a bf16 pair; the mask's bf16 bits) of chunk j
  auto load_taps = [&](int j, uint32_t (&d)[kItems],
                       unsigned short (&m)[kItems]) {
    const int k = j / n_cc;
    const int grp = ((j - k * n_cc) * kCKb + unit * kU) / kCg;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = ((p0 + row0 + kRowsPass * i) * dg + grp) * 9 + k;
      const bool live = ih[i] >= 0;
      d[i] = live ? __ldg(reinterpret_cast<const unsigned int*>(offset) + idx)
                  : 0u;
      m[i] = live ? __ldg(reinterpret_cast<const unsigned short*>(mask) + idx)
                  : static_cast<unsigned short>(0);
    }
  };
  // chunk j's A tile into stage s: each item's corners and weights, its
  // four corner loads, the modulated value rounded where the TPU kernel
  // rounds, one 16- (or 8-) byte store in the 128-byte swizzle
  auto gather = [&](int j, int s, const uint32_t (&d)[kItems],
                    const unsigned short (&m)[kItems]) {
    const int k = j / n_cc;
    const int c0 = (j - k * n_cc) * kCKb + unit * kU;
    unsigned char* const a = smem + s * kStageB;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int row = row0 + kRowsPass * i;
      uint32_t packed[kU / 2];
#pragma unroll
      for (int e = 0; e < kU / 2; ++e) packed[e] = 0u;
      if (ih[i] >= 0) {
        const float mm = __uint_as_float(static_cast<uint32_t>(m[i]) << 16);
        const float sy = bf::round_bf16(
            __fadd_rn(static_cast<float>(ih[i] + k / 3 - 1), bf::lo(d[i])));
        const float sx = bf::round_bf16(
            __fadd_rn(static_cast<float>(iw[i] + k % 3 - 1), bf::hi(d[i])));
        const float y0 = floorf(sy), x0 = floorf(sx);
        const bool yin0 = y0 >= 0.f && y0 <= H - 1;
        const bool yin1 = y0 + 1.f >= 0.f && y0 + 1.f <= H - 1;
        const bool xin0 = x0 >= 0.f && x0 <= W - 1;
        const bool xin1 = x0 + 1.f >= 0.f && x0 + 1.f <= W - 1;
        const float wx0 =
            xin0 ? bf::round_bf16(fmaxf(1.f - fabsf(sx - x0), 0.f)) : 0.f;
        const float wx1 =
            xin1 ? bf::round_bf16(fmaxf(1.f - fabsf(sx - (x0 + 1.f)), 0.f))
                 : 0.f;
        const float wy0 = yin0 ? fmaxf(1.f - fabsf(sy - y0), 0.f) : 0.f;
        const float wy1 = yin1 ? fmaxf(1.f - fabsf(sy - (y0 + 1.f)), 0.f)
                               : 0.f;
        const int ya = static_cast<int>(fminf(fmaxf(y0, 0.f), H - 1.f));
        const int yb = static_cast<int>(fminf(fmaxf(y0 + 1.f, 0.f), H - 1.f));
        const int xa = static_cast<int>(fminf(fmaxf(x0, 0.f), W - 1.f));
        const int xb = static_cast<int>(fminf(fmaxf(x0 + 1.f, 0.f), W - 1.f));
        const int pix0 = p0 + row - ih[i] * W - iw[i];
        const __nv_bfloat16* xq = x + c0;
        const uint4 r00 = load_channels<kU>(xq + (pix0 + ya * W + xa) * C);
        const uint4 r01 = load_channels<kU>(xq + (pix0 + ya * W + xb) * C);
        const uint4 r10 = load_channels<kU>(xq + (pix0 + yb * W + xa) * C);
        const uint4 r11 = load_channels<kU>(xq + (pix0 + yb * W + xb) * C);
#pragma unroll
        for (int e = 0; e < kU / 2; ++e) {
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t w00 = word(r00, e), w01 = word(r01, e);
            const uint32_t w10 = word(r10, e), w11 = word(r11, e);
            const float a00 = h ? bf::hi(w00) : bf::lo(w00);
            const float a01 = h ? bf::hi(w01) : bf::lo(w01);
            const float a10 = h ? bf::hi(w10) : bf::lo(w10);
            const float a11 = h ? bf::hi(w11) : bf::lo(w11);
            const float t0 =
                __fadd_rn(__fmul_rn(a00, wx0), __fmul_rn(a01, wx1));
            const float t1 =
                __fadd_rn(__fmul_rn(a10, wx0), __fmul_rn(a11, wx1));
            v[h] = __fmul_rn(
                __fadd_rn(__fmul_rn(t0, wy0), __fmul_rn(t1, wy1)), mm);
          }
          packed[e] = bf::pack(v[0], v[1]);
        }
      }
      const int ch = unit * kU;   // the item's first channel in the chunk
      unsigned char* dst =
          a + row * wga::kAtomRow + (((ch >> 3) ^ (row & 7)) << 4)
          + (ch & 7) * 2;
      if constexpr (kU == 8) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      }
    }
  };
  // chunk j's weight rows k C + c0 .. + 63 of the (9 C, 128) weight into
  // stage s, MN-major: two atoms of 64 outputs
  auto issue_weights = [&](int j, int s) {
    const int k = j / n_cc;
    const __nv_bfloat16* src =
        weight + (static_cast<size_t>(k) * C + (j - k * n_cc) * kCKb) * kO;
    const uint32_t dst = base + s * kStageB + kAStageB;
#pragma unroll
    for (int i = 0; i < kCKb * (kO / 8) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kO / 8), c = e % (kO / 8);
      wga::cp_async16(dst + wga::swizzled(r, c, kWAtomB), src + r * kO + 8 * c,
                      true);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // chunk j: A and weights in stage (j - j0) % 3. Its raw taps are loaded
  // a chunk ahead, under the gather before; its weights issued a chunk
  // ahead, under its own gather; its products run under the next chunk's
  // gather. With 3 stages, the barrier of chunk j - 1 follows every warp's
  // wait for the products of chunk j - 3, so one barrier a chunk orders
  // both reuses of a stage.
  uint32_t d_next[kItems], d_cur[kItems];
  unsigned short m_next[kItems], m_cur[kItems];
  issue_weights(j0, 0);
  bf::cp_async_commit();
  load_taps(j0, d_next, m_next);
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0, s = it % kStagesB;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      d_cur[i] = d_next[i];
      m_cur[i] = m_next[i];
    }
    if (j + 1 < j1) load_taps(j + 1, d_next, m_next);
    gather(j, s, d_cur, m_cur);
    bf::cp_async_wait<0>();
    wga::proxy_fence();   // A and weights visible to wgmma
    __syncthreads();
    if (j + 1 < j1) issue_weights(j + 1, (it + 1) % kStagesB);
    bf::cp_async_commit();
    const uint32_t a_addr = base + s * kStageB;
    const uint64_t da = wga::desc_k_major(a_addr);
    const uint64_t db = wga::desc_mn_major(a_addr + kAStageB, kWAtomB);
    wga::pin(acc);
    wga::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCKb / 16; ++kk)
      mma_ss_n128_mn(acc, da + kk * 32 / 16, db + kk * 16 * wga::kAtomRow / 16);
    wga::wgmma_commit();
    wga::wgmma_wait<1>();
    wga::pin(acc);
  }
  wga::wgmma_wait<0>();
  wga::pin(acc);
  __syncthreads();   // every product done: the stages hold the partials

  // this block's partial sums -> shared memory [kBPb][kLdPb]: thread (warp,
  // g, t) holds rows 16 warp + g (+ 8), columns 8 jn + 2t, + 1
  float* const part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int jn = 0; jn < kO / 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (16 * warp + g + 8 * h) * kLdPb
                                 + 8 * jn + 2 * t) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();      // every block's part written
  // block r of the cluster sums rows [64r/n, 64(r+1)/n) of every part in
  // rank order; the sum rounded to bf16, then + bias in bf16
  const int r0 = kBPb * rank / n_split, r1 = kBPb * (rank + 1) / n_split;
  for (int e = tid; e < (r1 - r0) * (kO / 4); e += kThreads) {
    const int row = r0 + e / (kO / 4), c4 = 4 * (e % (kO / 4));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < n_split; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + row * kLdPb + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (p0 + row < n_pos) {
      const uint2 bv = __ldg(reinterpret_cast<const uint2*>(bias + c4));
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(p0 + row) * kO
                                + c4) = make_uint2(
          bf::pack(__fadd_rn(bf::round_bf16(s.x), bf::lo(bv.x)),
                   __fadd_rn(bf::round_bf16(s.y), bf::hi(bv.x))),
          bf::pack(__fadd_rn(bf::round_bf16(s.z), bf::lo(bv.y)),
                   __fadd_rn(bf::round_bf16(s.w), bf::hi(bv.y))));
    }
  }
  cluster.sync();      // no block leaves while another reads its part
}

template <int kCg>
bool conv_bf16_configured[kMaxDevices] = {};

template <int kCg>
int launch_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* offset,
                     const __nv_bfloat16* mask, const __nv_bfloat16* weight,
                     const __nv_bfloat16* bias, __nv_bfloat16* out, int n_pos,
                     int H, int W, int C, int split, cudaStream_t stream) {
  return launch_split(deform_conv_bf16_kernel<kCg>, conv_bf16_configured<kCg>,
                      kSmemB, kThreads, (n_pos + kBPb - 1) / kBPb, split,
                      stream, x, offset, mask, weight, bias, out, n_pos, H, W,
                      C, split);
}

template <int kCg>
int conv_bf16_info(int* info) {
  return split_info(deform_conv_bf16_kernel<kCg>, conv_bf16_configured<kCg>,
                    kSmemB, kThreads, kBPb, info);
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

// The bf16 form of K3: every tensor bf16, in K3's layouts; C % 64 == 0,
// each 64-position tile's chunks split over a cluster of `split` blocks.
extern "C" int modulated_deform_conv2d_bf16(const void* x, const void* offset,
                                            const void* mask,
                                            const void* weight,
                                            const void* bias, void* out,
                                            int B, int H, int W, int C,
                                            int dg, int split, void* stream) {
  if (dg < 1 || C % dg != 0 || C % kCKb != 0 || split < 1
      || split > kMaxSplit || split > 9 * C / kCKb)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto launch) {
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(offset),
                  static_cast<const __nv_bfloat16*>(mask),
                  static_cast<const __nv_bfloat16*>(weight),
                  static_cast<const __nv_bfloat16*>(bias),
                  static_cast<__nv_bfloat16*>(out), B * H * W, H, W, C, split,
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
