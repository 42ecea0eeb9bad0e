// The bf16 attention tile of Hopper shared by the bf16 forms of K4
// (window_attention.cu) and K5 (sparse_window_attention.cu): head width
// 128, both products on wgmma, K/V streamed through a ring of shared
// memory stages guarded by mbarriers, one producer warpgroup feeding two
// consumer warpgroups.
//
// Block. One block of 384 threads per (problem, 128-query tile), one block
// per SM: warpgroup 0 is the producer (it fills the ring, TMA for K4,
// rows gathered with 16-byte cp.async for K5, and gives up registers with
// setmaxnreg), warpgroups 1 and 2 are the consumers, 64 query rows each,
// and stream every key tile of the problem through an online softmax.
// 128 query rows a block, against the 64 of the mma.sync tile, halve the
// re-reads of each problem's K/V from L2.
//
// Shared memory (from a 1024-byte aligned base), every tile in the
// 128-byte swizzle that TMA writes and the wgmma descriptors read: a row
// of 64 bf16 (128 bytes) per swizzle row, so a 128-wide head is two
// "atoms" of 64 columns, atom a holding d = 64a .. 64a + 63:
//   Q          [2 atoms][128 rows][64]          32 KB, loaded once
//   K, V [s]   [2 atoms][BN keys][64] each      BN / 4 KB each, per stage
//   barriers   q_full, k_full[s], v_full[s], k_empty[s], v_empty[s]
// Ring<BN>: key tiles of BN = 128 keys in 2 stages (K4, 161 KB) or of 64
// keys in 3 stages (K5, 129 KB; its hi + lo P needs the registers that a
// 128-key S would take). Separate K and V barriers let S = Q·Kᵀ of a tile
// start before its V has landed, and the producer refill a K slot as soon
// as its S is done.
//
// Products (per consumer warpgroup and key tile):
//   S = Q·Kᵀ   8 x wgmma.m64nBNk16 SS, Q and K both K-major (tnspB 0);
//   O += P·V   BN / 16 x wgmma.m64n128k16 RS per pass: P from registers
//              (the accumulator layout of S is, pair for pair, the
//              A-fragment layout of the k-step over the same 16 keys), V as
//              B from shared memory in MN-major order (tnspB 1).
// Softmax in fp32 registers in log2 units: the fp32 logit times scale ·
// log2 e plus the key's bias (log2 units; -inf for a dead key, which
// gets probability 0 exactly). The running max starts at -inf and the
// first live tile's rescale factor is 0, so a tile masked completely
// carries nothing forward and yields no NaN.
//
// Overlap (FlashAttention-3's two levels). Inside a warpgroup: tile j's S
// product is issued, the rows rescaled by tile j - 1's softmax, tile j -
// 1's P·V issued, and tile j's softmax runs while P·V is in flight; P is
// packed from the probabilities once that P·V has retired. Between the
// two warpgroups (ping-pong): they take turns to issue their products on
// two named barriers, so one's softmax runs under the other's products
// (measured faster on an H100 for both kernels). Every descriptor of a
// product is its first one plus constants and the warpgroup index is
// made warp-uniform, so no instruction but wgmma defines a wgmma operand
// between issue and wait: ptxas serializes wgmma otherwise.
//
// Two forms of P·V (kLo):
//   K4 bf16: one pass of bf16(p) (the TPU kernel rounds p to bf16);
//   K5 bf16: P as bf16 hi + bf16 lo (lo = p - hi) over the same V tile,
//            16 significant bits of p, since the TPU kernel keeps p fp32.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace wga {

constexpr int kD = 128;                      // head width
constexpr int kBQ = 128;                     // query rows per block
constexpr int kThreads = 384;                // producer + 2 consumer WGs
constexpr int kConsumerWarps = 8;
constexpr int kAtomRow = 128;                // bytes per swizzled row
constexpr int kQAtom = kBQ * kAtomRow;       // one Q atom, 16 KB
constexpr int kQBytes = 2 * kQAtom;
constexpr float kLog2e = 1.4426950408889634f;
// registers: the producer gives its own to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536,
              "register file");

// ---- shared memory -------------------------------------------------------

// The ring for key tiles of BN keys (64 or 128): its geometry, and the
// shared addresses of its parts from the aligned base.
template <int BN>
struct Ring {
  static constexpr int kBN = BN;
  static constexpr int kStages = BN == 64 ? 3 : 2;
  static constexpr int kTileAtom = BN * kAtomRow;   // one K or V atom
  static constexpr int kTileBytes = 2 * kTileAtom;
  static constexpr int kKSteps = BN / 16;           // P·V k-steps
  static constexpr int kBlocks = BN / 8;            // n8 blocks of S
  static constexpr int kLayoutBytes =
      kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 4 * kStages);
  // the dynamic allocation: the layout plus room to align its base
  static constexpr int kSmemBytes = kLayoutBytes + 1024;

  uint32_t base;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t k(int s) const {
    return base + kQBytes + s * 2 * kTileBytes;
  }
  __device__ __forceinline__ uint32_t v(int s) const {
    return k(s) + kTileBytes;
  }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + kQBytes + 2 * kStages * kTileBytes + 8 * i;
  }
  __device__ __forceinline__ uint32_t q_full() const { return bar(0); }
  __device__ __forceinline__ uint32_t k_full(int s) const {
    return bar(1 + s);
  }
  __device__ __forceinline__ uint32_t v_full(int s) const {
    return bar(1 + kStages + s);
  }
  __device__ __forceinline__ uint32_t k_empty(int s) const {
    return bar(1 + 2 * kStages + s);
  }
  __device__ __forceinline__ uint32_t v_empty(int s) const {
    return bar(1 + 3 * kStages + s);
  }
};

template <int BN>
__device__ __forceinline__ Ring<BN> carve(unsigned char* smem) {
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return Ring<BN>{(raw + 1023u) & ~1023u};
}

// ---- barriers ------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed (a barrier just
// initialised counts its phase before as completed: parity 1 passes).
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ---- copies --------------------------------------------------------------

// One box of a 3-D tensor map (c0 innermost) into shared address dst,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// 16 bytes from src to shared address dst, or 16 zero bytes when !live.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0) : "memory");
}

// The barrier counts one arrival of this thread once all its earlier
// cp.async copies have landed (the arrival is one of its expected count).
__device__ __forceinline__ void bar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::
                   "r"(bar) : "memory");
}

// Makes shared memory written through the generic proxy (cp.async) visible
// to wgmma's reads (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset of 16-byte chunk c (0 .. 15 over d) of row r in a tile of
// two swizzled atoms of `atom` bytes each: the 128-byte swizzle that TMA
// writes.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int atom) {
  return (c >> 3) * atom + r * kAtomRow + (((c & 7) ^ (r & 7)) << 4);
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each in 16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// K-major operand (Q or K): rows 128 bytes apart, 8-row groups 1024 apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc(addr, 16, 1024);
}

// MN-major B (V, keys x d): 8-key groups 1024 bytes apart, the second 64
// columns of d one atom (`atom` bytes) further.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t atom) {
  return desc(addr, atom, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving registers that an asynchronous wgmma
// reads or writes across the points where this is placed.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WGA_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define WGA_F16(a, i) \
  WGA_F4(a, i), WGA_F4(a, i + 4), WGA_F4(a, i + 8), WGA_F4(a, i + 12)

// s (+)= A·B over one k-step of 16: A 64 x 16 and B 64 (n) x 16, both
// K-major in shared memory; s is overwritten when !accumulate.
__device__ __forceinline__ void mma_ss_n64(float (&s)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : WGA_F16(s, 0), WGA_F16(s, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with B 128 (n) x 16.
__device__ __forceinline__ void mma_ss_n128(float (&s)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}"
      : WGA_F16(s, 0), WGA_F16(s, 16), WGA_F16(s, 32), WGA_F16(s, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_ss(float (&s)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n64(s, da, db, accumulate);
}
__device__ __forceinline__ void mma_ss(float (&s)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n128(s, da, db, accumulate);
}

// o += A·B over one k-step of 16: A 64 x 16 bf16 from registers, B 16
// (keys) x 128 (n) MN-major in shared memory.
__device__ __forceinline__ void mma_rs_n128(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : WGA_F16(o, 0), WGA_F16(o, 16), WGA_F16(o, 32), WGA_F16(o, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WGA_F16
#undef WGA_F4

// ---- the consumers' online softmax ---------------------------------------

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One consumer warpgroup's rows: thread (warp w of the group, g = lane /
// 4, t = lane % 4) holds rows 16w + g and 16w + g + 8 of the group's 64;
// accumulator element 4j + e of an n-wide product is row 16w + g + 8 (e
// >> 1), column 8j + 2t + (e & 1), as for mma.sync.
struct Rows {
  float o[64];   // O, 64 rows x 128
  float m[2];    // running max (log2 units)
  float l[2];    // this thread's part of the running sum
};

// Probabilities of one tile of BN keys as A fragments, k-step kk over
// keys 16 kk .. 16 kk + 15 (hi, and lo = p - hi when kLo).
template <int BN, bool kLo>
struct Probs {
  uint32_t hi[BN / 16][4];
  uint32_t lo[kLo ? BN / 16 : 1][4];
};

// The softmax of one tile's logits s (m64nBN accumulator), in place: s
// becomes the tile's probabilities (fp32), alpha the rows' rescale
// factors. qscale = scale · log2 e; bias[j][c]: the bias (log2 units, -inf
// for a dead key) of the tile's key 8j + 2t + c; visible(i, j, c): whether
// row g + 8i sees that key.
template <int BN, class Visible>
__device__ __forceinline__ void softmax(float (&s)[BN / 2], Rows& r,
                                        float qscale,
                                        const float (&bias)[BN / 8][2],
                                        Visible visible, float (&alpha)[2]) {
  float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = visible(e >> 1, j, e & 1) ? x * qscale + bias[j][e & 1]
                                    : -CUDART_INF_F;
      mt[e >> 1] = fmaxf(mt[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(r.m[i], quad_max(mt[i]));
    alpha[i] = r.m[i] == -CUDART_INF_F ? 0.f : exp2_approx(r.m[i] - m_new);
    r.m[i] = m_new;
    r.l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      x = x == -CUDART_INF_F ? 0.f : exp2_approx(x - r.m[e >> 1]);
      r.l[e >> 1] += x;
    }
}

// The probabilities s as A fragments: k-step kk takes n8 blocks 2kk
// (registers 0, 1) and 2kk + 1 (2, 3).
template <int BN, bool kLo>
__device__ __forceinline__ void to_probs(const float (&s)[BN / 2],
                                         Probs<BN, kLo>& p) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int j = 2 * kk + (h >> 1), e = 2 * (h & 1);
      const float a = s[4 * j + e], b = s[4 * j + e + 1];
      p.hi[kk][h] = pack_bf16(a, b);
      if constexpr (kLo) {
        const __nv_bfloat162 hv =
            *reinterpret_cast<const __nv_bfloat162*>(&p.hi[kk][h]);
        p.lo[kk][h] = pack_bf16(a - __low2float(hv), b - __high2float(hv));
      }
    }
}

template <int BN, bool kLo>
__device__ __forceinline__ void pin(Probs<BN, kLo>& p) {
  pin(p.hi);
  if constexpr (kLo) pin(p.lo);
}

// Issues O += P·V over the V tile at shared address v (one pass, or hi
// then lo).
// (The descriptors of a product are its first one plus constant offsets
// in 16-byte units, so nothing but wgmma defines their registers between
// the products: ptxas serializes wgmma otherwise.)
template <int BN, bool kLo>
__device__ __forceinline__ void issue_pv(Rows& r, const Probs<BN, kLo>& p,
                                         uint32_t v) {
  const uint64_t dv = desc_mn_major(v, Ring<BN>::kTileAtom);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs_n128(r.o, p.hi[kk], dv + kk * 16 * kAtomRow / 16);
  if constexpr (kLo) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      mma_rs_n128(r.o, p.lo[kk], dv + kk * 16 * kAtomRow / 16);
  }
}

// Issues S = Q·Kᵀ for the group's 64 rows of the Q tile at q (atoms of
// kQAtom bytes) and the K tile at k.
template <int BN>
__device__ __forceinline__ void issue_s(float (&s)[BN / 2], uint32_t q,
                                        uint32_t k) {
  const uint64_t dq = desc_k_major(q), dk = desc_k_major(k);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int col = (kk & 3) * 32;
    mma_ss(s, dq + ((kk >> 2) * kQAtom + col) / 16,
           dk + ((kk >> 2) * Ring<BN>::kTileAtom + col) / 16, kk > 0);
  }
}

// Named barriers kTurn, kTurn + 1 order the consumer groups' turns.
constexpr int kTurn = 8;

// One consumer warpgroup (group 0 or 1 of the block) over key tiles 0 ..
// n_tiles - 1 of the ring. tile_bias(tile, bias) fills the tile's key
// biases (see softmax); visible(tile, i, j, c) masks pairs. kCpAsync: the
// ring is filled by cp.async, so a proxy fence follows the waits for a
// tile's K and the tile before's V. The caller has waited for Q.
template <int BN, bool kLo, bool kCpAsync, class TileBias, class Visible>
__device__ __forceinline__ void consume(const Ring<BN>& sm, int group,
                                        int n_tiles, float qscale,
                                        TileBias tile_bias, Visible visible,
                                        Rows& r) {
  const int lane = threadIdx.x % 32;
  const uint32_t q = sm.q() + group * 64 * kAtomRow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r.m[i] = -CUDART_INF_F;
    r.l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) r.o[i] = 0.f;
  if (n_tiles <= 0) return;

  constexpr int kStages = Ring<BN>::kStages;
  float s[BN / 2];
  float bias[BN / 8][2];
  float alpha[2];
  Probs<BN, kLo> p;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) bar_arrive(bar);
  };
  auto visible_of = [&](int tile) {
    return [&, tile](int i, int j, int c) { return visible(tile, i, j, c); };
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) r.o[i] *= alpha[(i >> 1) & 1];
  };

  // The two groups take turns to issue their products (named barriers
  // kTurn + group): group 0 first, then each group's issue lets the other
  // go, so one group's softmax runs under the other's products. Both
  // groups stream the same n_tiles, so the turns pair up: group 1 skips
  // the hand-over after its last turn.
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;" ::"r"(kTurn + group) : "memory");
  };
  auto hand_over = [&](int j) {
    if (group == 0 || j < n_tiles - 1)
      asm volatile("bar.arrive %0, 256;" ::"r"(kTurn + 1 - group)
                   : "memory");
  };
  if (group == 1) asm volatile("bar.arrive %0, 256;" ::"r"(kTurn) : "memory");

  // tile 0: S, softmax
  bar_wait(sm.k_full(0), 0);
  if constexpr (kCpAsync) proxy_fence();
  pin(s);
  my_turn();
  wgmma_fence();
  issue_s<BN>(s, q, sm.k(0));
  wgmma_commit();
  hand_over(0);
  wgmma_wait<0>();
  pin(s);
  tile_bias(0, bias);
  release(sm.k_empty(0));
  softmax<BN>(s, r, qscale, bias, visible_of(0), alpha);
  to_probs<BN, kLo>(s, p);

  // tile j: S of tile j and P·V of tile j - 1 in flight together, then
  // tile j's softmax under the P·V (as FlashAttention-3 orders them)
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    bar_wait(sm.k_full(st), (j / kStages) & 1);
    if constexpr (kCpAsync) {
      bar_wait(sm.v_full(prev), ((j - 1) / kStages) & 1);
      proxy_fence();
    }
    if constexpr (!kCpAsync)
      bar_wait(sm.v_full(prev), ((j - 1) / kStages) & 1);
    pin(s);
    my_turn();
    wgmma_fence();
    issue_s<BN>(s, q, sm.k(st));
    wgmma_commit();
    rescale();   // by tile j - 1's softmax
    pin(r.o);
    pin(p);
    wgmma_fence();
    issue_pv<BN, kLo>(r, p, sm.v(prev));
    wgmma_commit();
    hand_over(j);
    tile_bias(j, bias);
    wgmma_wait<1>();   // S of tile j
    pin(s);
    release(sm.k_empty(st));
    softmax<BN>(s, r, qscale, bias, visible_of(j), alpha);
    wgmma_wait<0>();   // P·V of tile j - 1
    pin(r.o);
    pin(p);
    release(sm.v_empty(prev));
    to_probs<BN, kLo>(s, p);
  }
  const int last = (n_tiles - 1) % kStages;
  rescale();
  bar_wait(sm.v_full(last), ((n_tiles - 1) / kStages) & 1);
  if constexpr (kCpAsync) proxy_fence();
  pin(r.o);
  pin(p);
  wgmma_fence();
  issue_pv<BN, kLo>(r, p, sm.v(last));
  wgmma_commit();
  wgmma_wait<0>();
  pin(r.o);
  pin(p);
  release(sm.v_empty(last));
}

// Writes O / l of the group's rows below n_rows (rows counted from the
// block's first, at o) in bf16.
__device__ __forceinline__ void store(__nv_bfloat16* o, int group,
                                      int n_rows, const Rows& r) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / quad_sum(r.l[i]);
    const int row = 64 * group + 16 * warp + g + 8 * i;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = o + static_cast<size_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(r.o[4 * j + 2 * i] * inv,
                                r.o[4 * j + 2 * i + 1] * inv);
  }
}

// Barrier setup by thread 0, before the roles split: the full barriers
// expect `full_count` arrivals (1 for TMA with its transaction count, the
// producer's 128 threads for cp.async), the empty ones one per consumer
// warp.
template <int BN>
__device__ __forceinline__ void init_barriers(const Ring<BN>& sm,
                                              int full_count) {
  if (threadIdx.x == 0) {
    bar_init(sm.q_full(), full_count);
    for (int s = 0; s < Ring<BN>::kStages; ++s) {
      bar_init(sm.k_full(s), full_count);
      bar_init(sm.v_full(s), full_count);
      bar_init(sm.k_empty(s), kConsumerWarps);
      bar_init(sm.v_empty(s), kConsumerWarps);
    }
    bar_init_fence();
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
}

// ---- host ----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (the kernels'
// libraries are not linked against the driver).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over (n_problems, T, 128) bf16 rows, boxes of 64 columns x `rows`
// rows of one problem, in the 128-byte swizzle; rows past T read as
// zeros, so a box never straddles two problems.
inline int encode(CUtensorMap* map, const void* base, int n_problems, int T,
                  int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(n_problems)};
  const cuuint64_t strides[2] = {kD * 2,
                                 static_cast<cuuint64_t>(T) * kD * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kMaxDevices = 64;

// The block's warpgroup, 0 (producer), 1 or 2, as a value the compiler
// knows to be warp-uniform (wgmma descriptors live in uniform registers).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// The per-device launch setup of a kernel on the tile: more than 48 KB of
// dynamic shared memory, for the device current at the call.
template <int BN, class Kernel>
__host__ int configure(Kernel kernel, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (configured[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<BN>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured[dev] = true;
  return 0;
}

// info = {resident blocks per SM, dynamic shared memory bytes, threads
// per block, query rows per block, blocks per query tile}.
template <int BN, class Kernel>
__host__ int launch_info(Kernel kernel, bool (&configured)[kMaxDevices],
                         int* info) {
  const int err = configure<BN>(kernel, configured);
  if (err != 0) return err;
  info[1] = Ring<BN>::kSmemBytes;
  info[2] = kThreads;
  info[3] = kBQ;
  info[4] = 1;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      info, kernel, kThreads, Ring<BN>::kSmemBytes));
}

}  // namespace wga
