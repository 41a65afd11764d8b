// Constants and helpers shared by the attention kernels on Hopper
// (attention_fwd.cu: K6 and its packed form K1; attention_bwd.cu: K7/K8
// and K2; bf16 and fp32 alike), for a head width kD of 32 or 64.
//
// A 64-row operand tile of one head is 64 x kD bf16: rows of 2·kD bytes.
// At kD 64 a row is one 128-byte swizzle span (hopper.cuh's layout: TMA's
// 128-byte swizzle, 16-byte chunk c of row r at chunk c ^ (r % 8)); at kD 32
// a row is 64 bytes and the tile takes TMA's 64-byte swizzle, chunk c of
// row r at chunk c ^ ((r / 2) % 4), both the XOR of address bits [4, 7)
// or [4, 6) with bits [7, 10) or [7, 9). A wgmma descriptor reads either
// with its layout type (1 = 128B, 2 = 64B) and a stride byte offset of one
// 8-row group (8·2·kD bytes); a k16 step along a K-major row advances the
// start address by 32 bytes, and a k16 step down an MN-major tile (its rows
// the reduction) by 16 rows. Products over the head (q·kᵀ) take kD / 16 k16
// steps; products into the head (P·V, dS·K, ...) are m64nkDk16 with kD / 2
// accumulator registers a thread.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace vit {

// Element strides (batch, head, row) of one (B, H, S, kD) operand or head
// view of the attention kernels; head_dim is contiguous.
struct Strides {
  long long b, h, s;
};

// Offset of head (b, h) of an operand with strides `st`.
__device__ __forceinline__ size_t offset(const Strides& st, int b, int h) {
  return static_cast<size_t>(b) * st.b + static_cast<size_t>(h) * st.h;
}

// The head width's tile geometry and score scale.
template <int kD>
struct Head {
  static_assert(kD == 32 || kD == 64, "head_dim 32 or 64");
  static constexpr int kRowBytes = 2 * kD;
  static constexpr uint32_t kTileBytes = 64 * kRowBytes;  // a 64-row tile
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows
  static constexpr int kChunks = kRowBytes / 16;          // 16 B a row
  static constexpr int kSteps = kD / 16;  // k16 steps over the head
  static constexpr int kAcc = kD / 2;     // registers of a 64 x kD product
  static constexpr int kNt = kD / 8;      // its 8-column tiles
  // 1/√kD in fp32, as the JAX package's Python float meets fp32 scores:
  // 1/8 at 64 (exact, a power of two), fp32(1/√32) at 32
  static constexpr float kScale = kD == 64 ? 0.125f : 0.17677669529663687f;
  static constexpr bool kPow2 = kD == 64;
};

// The stored 16-byte chunk of logical chunk c in row r of a swizzled tile
// of kD-wide rows (an involution: the same map takes stored to logical).
template <int kD>
__device__ __forceinline__ int swizzled_chunk(int r, int c) {
  constexpr int kC = Head<kD>::kChunks;
  return c ^ ((r * kC / 8) % kC);
}

// Shared-memory matrix descriptors of a swizzled tile of kD-wide rows at
// `addr` (hopper.cuh:desc_sw128 at kD 64): K-major (the leading offset
// unused under the swizzle) and MN-major (8-row groups of the reduction
// one group apart; the leading offset, to the next atom along N, is never
// reached at N = kD).
template <int kD>
__device__ __forceinline__ uint64_t desc_kmaj(uint32_t addr) {
  constexpr uint64_t kLayout = kD == 64 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(Head<kD>::kGroupBytes >> 4) << 32) |
         (kLayout << 62);
}
template <int kD>
__device__ __forceinline__ uint64_t desc_mnmaj(uint32_t addr) {
  constexpr uint64_t kLayout = kD == 64 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(Head<kD>::kGroupBytes >> 4) << 16) |
         (static_cast<uint64_t>(Head<kD>::kGroupBytes >> 4) << 32) |
         (kLayout << 62);
}

namespace attn {

using namespace hopper;

// d (64 x 64) = A·Bᵀ over the head, from kParts-part tiles (hopper.cuh's
// six-term order), A's parts a_part bytes apart and B's b_part: e.g.
// s = Q·Kᵀ. The caller fences, commits and waits.
template <int kD, int kParts>
__device__ __forceinline__ void head_abt(float (&d)[32], uint32_t a,
                                         uint32_t a_part, uint32_t b,
                                         uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < Head<kD>::kSteps; ++ks)
      wgmma_ss<0>(d, desc_kmaj<kD>(a + split_a(t) * a_part + 32 * ks),
                  desc_kmaj<kD>(b + split_b(t) * b_part + 32 * ks),
                  t > kFirstTerm<kParts> || ks > 0);
}

// The same over 32 columns: d (64 x 32) = A·Bᵀ with B the 32 rows of a
// K-major tile from b (32 rows into it for its rows 32-63).
template <int kD, int kParts>
__device__ __forceinline__ void head_abt_n32(float (&d)[16], uint32_t a,
                                             uint32_t a_part, uint32_t b,
                                             uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < Head<kD>::kSteps; ++ks)
      wgmma_ss_n32<0>(d, desc_kmaj<kD>(a + split_a(t) * a_part + 32 * ks),
                      desc_kmaj<kD>(b + split_b(t) * b_part + 32 * ks),
                      t > kFirstTerm<kParts> || ks > 0);
}

// d (64 x kD) += A·B over 16·kSteps: A's parts as register fragments
// a[part][k16 step], B a kParts-part tile read MN-major from b (16 rows a
// k16 step), its parts b_part bytes apart; e.g. o += P·V.
template <int kD, int kParts, int kSteps>
__device__ __forceinline__ void head_rb(float (&d)[Head<kD>::kAcc],
                                        const uint32_t (&a)[kParts][kSteps][4],
                                        uint32_t b, uint32_t b_part) {
#pragma unroll
  for (int t = kFirstTerm<kParts>; t < 6; ++t)
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint64_t desc = desc_mnmaj<kD>(b + split_b(t) * b_part +
                                           16 * Head<kD>::kRowBytes * ks);
      if constexpr (kD == 64)
        wgmma_rs<1>(d, a[split_a(t)][ks], desc);
      else
        wgmma_rs_n32<1>(d, a[split_a(t)][ks], desc);
    }
}

// d += A·B (head_rb), waited for. The fp32 forms (kParts = 3) take each
// tile's product in a fresh accumulator and add it to d in registers,
// rounded to nearest: chained over all the tiles of a sum in d itself, the
// fp32 attention backward's means read 2e-6 to 7e-6 of mean |plain| on the
// H100, growing with the number of tiles, as the tensor cores' fp32
// accumulation loses low bits at each wgmma against a growing accumulator;
// a tile at a time, 3e-7 to 7e-7.
template <int kD, int kParts, int kSteps>
__device__ __forceinline__ void head_rb_into(
    float (&d)[Head<kD>::kAcc], const uint32_t (&a)[kParts][kSteps][4],
    uint32_t b, uint32_t b_part) {
  if constexpr (kParts == 1) {
    head_rb<kD, kParts, kSteps>(d, a, b, b_part);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  } else {
    float tile[Head<kD>::kAcc];
#pragma unroll
    for (int e = 0; e < Head<kD>::kAcc; ++e) tile[e] = 0.0f;
    head_rb<kD, kParts, kSteps>(tile, a, b, b_part);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tile);
#pragma unroll
    for (int e = 0; e < Head<kD>::kAcc; ++e) d[e] = __fadd_rn(d[e], tile[e]);
  }
}

// The exponent's argument of a bf16 kernel's p = exp(s·scale − m), with ml
// = m·log2(e), for exp2_approx: at kD 64 one FMA of the unscaled score (the
// scale a power of two, so the product is exact); otherwise the scaled
// score rounded first, as the JAX kernels multiply fp32 scores by 1/√d.
template <int kD>
__device__ __forceinline__ float exp2_arg(float acc, float ml) {
  if constexpr (Head<kD>::kPow2)
    return fmaf(acc, Head<kD>::kScale * kLog2e, -ml);
  else
    return fmaf(__fmul_rn(acc, Head<kD>::kScale), kLog2e, -ml);
}

// The fp32 forms' p = expf(s·scale − m): the plain version's rounding
// points (one subtraction of the rounded scaled score; exact at kD 64).
template <int kD>
__device__ __forceinline__ float exp_f32(float acc, float m) {
  if constexpr (Head<kD>::kPow2)
    return expf(fmaf(acc, Head<kD>::kScale, -m));
  else
    return expf(__fsub_rn(__fmul_rn(acc, Head<kD>::kScale), m));
}

// Head h's slices of the packed projection's (3·H·kD,) bf16 bias, q at
// h·kD, k at (H + h)·kD and v at (2H + h)·kD, into `dst` in shared memory:
// threads 0 .. 3·kD/8 − 1 of the block copy 16 bytes each; the caller
// synchronises.
template <int kD>
__device__ __forceinline__ void load_head_bias(bf16 (&dst)[3][kD],
                                               const bf16* bias, int h,
                                               int H) {
  constexpr int kPer = kD / 8;
  if (threadIdx.x < 3 * kPer) {
    const int part = threadIdx.x / kPer, c = 8 * (threadIdx.x % kPer);
    *reinterpret_cast<uint4*>(&dst[part][c]) = *reinterpret_cast<const uint4*>(
        bias + (static_cast<size_t>(part) * H + h) * kD + c);
  }
}

// Adds `bias` (kD bf16 in shared memory, 16-byte aligned) to rows [0, rows)
// of a 64 x kD bf16 tile that TMA wrote swizzled, in place: x = bf16(x +
// b), one rounding of the exact sum (bf16x2 fma by 1), as the packed
// projection's bias is added before the products.
// kThreads threads share the tile, thread `tid` taking the 16-byte chunks
// tid, tid + kThreads, ...: chunk i is row i / kChunks at stored chunk
// i % kChunks. With kThreads a multiple of 8·kChunks the logical chunk is
// the same for all of a thread's chunks, so each thread reads its 8 bias
// values once. Rows at or past `rows` (TMA's zero fill past S) stay zero.
// The caller fences and synchronises after it.
template <int kThreads, int kD>
__device__ __forceinline__ void add_head_bias(void* tile,
                                              const __nv_bfloat16* bias,
                                              int rows, int tid) {
  constexpr int kC = Head<kD>::kChunks;
  static_assert(kThreads % (8 * kC) == 0, "one bias chunk per thread");
  const int c = swizzled_chunk<kD>(tid / kC, tid % kC);
  const uint4 b = *reinterpret_cast<const uint4*>(bias + 8 * c);
  uint4* chunks = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int j = 0; j < kTileRows * kC / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (i / kC >= rows) continue;
    uint4 x = chunks[i];
    x.x = add_bf16x2(x.x, b.x);
    x.y = add_bf16x2(x.y, b.y);
    x.z = add_bf16x2(x.z, b.z);
    x.w = add_bf16x2(x.w, b.w);
    chunks[i] = x;
  }
}

}  // namespace attn
}  // namespace vit
