// K3 / K4: the frozen ConvNeXt block tail, forward and input gradient, for
// Hopper (sm_90a).
//
// Replace the Pallas kernels vit_tpu/kernels/convnext_block.py:_fwd_kernel
// (:89, launched by _fwd_impl :248) and _bwd_kernel (:109, launched by
// _bwd_impl :276), behind frozen_convnext_block_tail (:457). On rows
// (N, C) = the flattened B·H·W of a channels-last activation:
//   K3: y  = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2)
//   K4: dh from dy, recomputing z from h:
//       do = γ⊙dy; da = do·W2ᵀ; dz = da⊙gelu′(z); du = dz·W1ᵀ;
//       dh = rstd·(dû − mean(dû) − û·mean(dû⊙û)), dû = du⊙ln_scale.
// LN eps is given (1e-6), with the two-pass fp32 statistics of :80-86. GELU
// is the tanh-composed erf of vit_tpu/ops/gelu.py, and gelu′ its flat
// derivative (:60-77), from csrc/gelu.cuh. Rounding points follow the
// Pallas kernels: every parameter is bf16 (γ = 1e-6 rounds); u, a, do and
// dz are cast to bf16 before their products; accumulators and LN
// statistics are fp32.
//
// Weights arrive in PyTorch's Linear layout, w1 (4C, C) and w2 (C, 4C), and
// both kernels read them as they are: no transposed copy exists.
//
// Design (csrc/hopper.cuh has the primitives). A block is two consumer
// warpgroups and a producer warp, one thread of which issues every TMA
// load. It first loads the block's rows of h (and in K4 of dy) as 64 x 64
// boxes with the 128-byte swizzle (zeros past N and C); the consumers take
// the LN statistics from them and write u = bf16(LN(h)) over h in place (in
// K4 also do = bf16(γ·dy) over dy), so u and do are the A operands of every
// chunk's first products. The 4C dimension is streamed in chunks of 64: a
// chunk's tile of W1 (64 rows f x C columns c) and its tile of W2 (C rows
// c x 64 columns f) each arrive by TMA as ⌈C/64⌉ boxes, one ring stage a
// tile, signalled full by the transaction count of an mbarrier and handed
// back by one arrival from each consumer warp. The same tiles serve every
// product through the wgmma descriptors, so no transposed copy exists:
//   z  = u·W1ᵀ   W1's tile K-major (its rows are z's columns);
//   o += a·W2ᵀ   W2's tile K-major (K3);
//   da = do·W2   W2's tile MN-major, the transpose bit (K4);
//   du += dz·W1  W1's tile MN-major (K4).
// Widths:
//   C 96, 192: 128 rows, one warpgroup per 64 of them at the full width.
//     Each forms its chunk of z (wgmma m64n64) and a = gelu(z + b1), or
//     dz, in registers, repacks it to bf16 A fragments and accumulates
//     o or du (64 x C fp32: 64 or 96 registers; at C 96 the second atom's
//     columns past 96 multiply TMA's zeros) with the register-A wgmma.
//   C 384: 64 rows, the warpgroups own 192 output columns each (96
//     registers; one warpgroup at the full width would need 192). Each forms
//     half of the chunk's z, and of da (m64n32), writes its half of a, or
//     dz, to a shared tile swizzled as TMA swizzles, fences it to the async
//     proxy and meets the other at a named barrier; both then read the whole
//     tile as the shared-memory A operand. The tile is double-buffered.
// Each warpgroup runs a chunk's products and its GELU in turn; the two
// warpgroups of a block overlap one's GELU with the other's products. K4
// takes each chunk's W2 tile first (da, then released) so that the next
// chunk's W2 tile loads while z and du run. The ring holds as many tiles as
// fit in 227 KB beside u (and do): 2 to 8. The per-row epilogue (residual
// and γ, or the LN backward with per-row Σdû and Σdû·û across the
// warpgroups' columns) runs once at the end, its x or h read into registers
// at once. One block per SM (the shared memory), 168 registers a thread
// (nine warps); on the H100 a K3 whose z of the next chunk was issued
// before this chunk's GELU (two z accumulators) came out slower, as did
// issuing the loads from a consumer thread instead of the producer warp to
// lift the register cap to 255 (PERF.md §6).
//
// What bounds it: 4·C·4C FLOP per row forward (6·C·4C backward) against 3·C·2
// bytes of h, x and y (h, dy, dh): the (N, 4C) intermediate and the LN
// output never reach device memory, as on the TPU. Shared memory cannot
// hold the weights at C = 384 (W1 alone is 1.18 MB in bf16), so every block
// reads W1 and W2 once from L2: at 64-128 rows a block that is 64-128 FLOP
// per byte of L2 traffic, which with the tensor cores bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace vit;
using namespace vit::hopper;

constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kBlockThreads = kConsumers + 32;  // + the producer warp
constexpr int kChunk = 64;  // 4C columns per weight tile
// The dynamic shared memory a block may use, less the alignment slack
constexpr int kSmemLimit = 232448 - 1024;
// The ring's barriers (128 bytes), the row tiles' barrier and the row
// statistics
constexpr int kSmall = 4096;

// The tiling of width C, forward (kBwd false) or backward.
template <int C, bool kBwd>
struct Tail {
  static constexpr int kAtoms = (C + 63) / 64;  // 64-column atoms of a row
  static constexpr bool kSplit = C > 192;       // warpgroups share 64 rows
  static constexpr int kRows = kSplit ? 64 : 128;  // rows per block
  static constexpr int kOwn = kSplit ? kAtoms / 2 : kAtoms;  // output atoms
  static constexpr int kChunks = 4 * C / kChunk;
  static constexpr int kRowTile = kAtoms * kRows * 128;  // h → u, dy → do
  static constexpr int kWTile = kAtoms * static_cast<int>(kTileBytes);
  // a (K3) or dz (K4) exchange tiles at C 384, two in turn
  static constexpr int kActTiles = kSplit ? 2 : 0;
  // Byte offsets: u, do (K4), the exchange tiles, the ring of weight
  // tiles, then the small region
  static constexpr int kDo = kRowTile;
  static constexpr int kAct = kDo + (kBwd ? kRowTile : 0);
  static constexpr int kW = kAct + kActTiles * static_cast<int>(kTileBytes);
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kWTile;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kW + kStages * kWTile;
  static constexpr int kRowsBar = kRing + 128;
  static constexpr int kStats = kRing + 256;
  static constexpr int kBytes = kRing + kSmall + 1024;
  static_assert(C % 32 == 0 && C <= 384, "C a multiple of 32, at most 384");
  static_assert(kStages >= 2, "a chunk's two tiles must fit the ring");
  static_assert(sizeof(Ring<kStages>) <= 128, "the ring's barriers");
  static_assert(256 + 6 * kRows * 4 <= kSmall, "the row statistics");
};

// x as a value the compiler cannot see through, so that descriptors formed
// from it are formed where they are used instead of being kept in
// registers across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Byte offset of element (row, col) in a [C/64 atoms][rows][128 bytes] bf16
// region, swizzled as TMA's 128-byte swizzle places it: the 16-byte chunk c
// of a row r at chunk c ^ (r % 8).
__device__ __forceinline__ int sw_offset(int row, int col, int rows) {
  return (col / 64) * rows * 128 + row * 128 +
         ((((col % 64) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
}

// The block's row tiles (h, and in K4 dy) as [atoms][rows] boxes in TMA's
// swizzled layout, rows past N arriving as zeros. One thread calls this.
template <int C, bool kBwd>
__device__ __forceinline__ void load_rows(uint8_t* sm, const CUtensorMap* trows,
                                          const CUtensorMap* tdy, int r0) {
  using L = Tail<C, kBwd>;
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(sm + L::kRowsBar);
  mbar_arrive_expect_tx(rows_full, L::kRowTile * (kBwd ? 2 : 1));
#pragma unroll
  for (int rr = 0; rr < L::kRows / 64; ++rr)
#pragma unroll
    for (int b = 0; b < L::kAtoms; ++b) {
      const int off = b * L::kRows * 128 + rr * static_cast<int>(kTileBytes);
      tma_load_2d(sm + off, trows, rows_full, 64 * b, r0 + 64 * rr);
      if constexpr (kBwd)
        tma_load_2d(sm + L::kDo + off, tdy, rows_full, 64 * b, r0 + 64 * rr);
    }
}

// The producer: the row tiles, then both weight tiles of every chunk in the
// order the consumers take them (K3: W1_j then W2_j; K4: W2_j then W1_j),
// each as soon as its ring stage is free.
template <int C, bool kBwd>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* trows,
                                        const CUtensorMap* tdy,
                                        const CUtensorMap* tw1,
                                        const CUtensorMap* tw2, int r0) {
  using L = Tail<C, kBwd>;
  load_rows<C, kBwd>(sm, trows, tdy, r0);
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  for (int i = 0; i < 2 * L::kChunks; ++i) {
    const bool w1 = (i % 2 == 0) != kBwd;
    const int st = ring.stage(i), f0 = (i / 2) * kChunk;
    uint8_t* dst = sm + L::kW + st * L::kWTile;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], L::kWTile);
#pragma unroll
    for (int b = 0; b < L::kAtoms; ++b) {
      if (w1)
        tma_load_2d(dst + b * kTileBytes, tw1, &ring.full[st], 64 * b, f0);
      else
        tma_load_2d(dst + b * kTileBytes, tw2, &ring.full[st], f0, 64 * b);
    }
  }
}

// LayerNorm of the block's kRows rows, read from the swizzled h tile that
// TMA wrote into `u`: two-pass fp32 statistics, and the affine output
// u = û·ln_scale + ln_bias rounded to bf16, written over h in place. Rows
// past N are zeros (û = 0, u = ln_bias: finite, never stored). Each
// consumer warp takes kRows / 8 rows, all of them read before any is
// reduced, so their shuffles interleave.
template <int C, int kRows>
__device__ __forceinline__ void layer_norm_rows(uint8_t* u, float* mu_s,
                                                float* rstd_s,
                                                const bf16* __restrict__ lns,
                                                const bf16* __restrict__ lnb,
                                                float eps) {
  constexpr int kPer = kRows / (kConsumers / 32), kV = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v[kPer][kV];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kV; ++j)
      v[i][j] = __bfloat162float(*reinterpret_cast<const bf16*>(
          u + sw_offset(warp * kPer + i, lane + 32 * j, kRows)));
  float sc[kV], bi[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sc[j] = __bfloat162float(lns[lane + 32 * j]);
    bi[j] = __bfloat162float(lnb[lane + 32 * j]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = warp * kPer + i;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) sum += v[i][j];
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      v[i][j] -= mu;
      sq += v[i][j] * v[i][j];
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float uhat = v[i][j] * rstd;
      *reinterpret_cast<bf16*>(u + sw_offset(r, lane + 32 * j, kRows)) =
          __float2bfloat16(uhat * sc[j] + bi[j]);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
}

// Which rows and output columns a consumer thread holds: warpgroup wg, its
// warp w and the accumulator layout's g, t (hopper.cuh).
template <int C, bool kBwd>
struct Thread {
  using L = Tail<C, kBwd>;
  int wg, warp, g, t, rg, cg;
  __device__ Thread() {
    wg = threadIdx.x / 128;
    warp = (threadIdx.x % 128) / 32;
    g = (threadIdx.x % 32) / 4;
    t = threadIdx.x % 4;
    rg = L::kSplit ? 0 : wg;  // 64-row group in the block
    cg = L::kSplit ? wg : 0;  // output-column half (C 384)
  }
  // The block row of accumulator row half r (0, 1)
  __device__ int row(int r) const { return rg * 64 + warp * 16 + g + 8 * r; }
  // The output column of accumulator element (atom at, 8-column tile nt)
  __device__ int col(int at, int nt) const {
    return (cg * L::kOwn + at) * 64 + nt * 8 + 2 * t;
  }
};

// Shared address of k16 step ks of this warpgroup's 64 rows of a swizzled
// row region (u or do) as a K-major A operand.
template <int kRows>
__device__ __forceinline__ uint32_t a_rows(uint32_t region, int rg, int ks) {
  return region + (ks / 4) * kRows * 128 + rg * kTileBytes + (ks % 4) * 32;
}

// f(e, column) of each element e of a 64 x 64 accumulator (its column in
// the chunk), rounded to bf16 as the A fragments of four k16 steps: two
// neighbouring 8-column tiles make one step.
template <typename F>
__device__ __forceinline__ void to_fragments(uint32_t (&af)[4][4], F f,
                                             int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    af[nt / 2][(nt % 2) * 2 + 0] = pack_bf16x2(f(4 * nt, col), f(4 * nt + 1, col + 1));
    af[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(f(4 * nt + 2, col), f(4 * nt + 3, col + 1));
  }
}

// f(e, column) of each element e of a 64 x 32 accumulator (columns c0 ..
// c0 + 31 of the chunk), rounded to bf16, into the swizzled 64 x 64
// exchange tile `act`; then the fence that lets a wgmma read it. The caller
// meets the other warpgroup after it.
template <typename F>
__device__ __forceinline__ void to_exchange(uint8_t* act, F f, int c0,
                                            int row0, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = 4 * nt + 2 * r;
      *reinterpret_cast<uint32_t*>(act + sw_offset(row0 + 8 * r, col, 64)) =
          pack_bf16x2(f(e, col), f(e + 1, col + 1));
    }
  }
  fence_proxy_async();
}

__device__ __forceinline__ float bf(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float2 bf2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 bf2(const bf16* p) {
  return bf2(*reinterpret_cast<const uint32_t*>(p));
}

// This thread's bf16 pairs of the (N, C) rows `src` at its accumulator
// positions, zeros past N or C: read at once, ahead of an epilogue.
template <int C, bool kBwd>
__device__ __forceinline__ void load_pairs(
    uint32_t (&raw)[2][Tail<C, kBwd>::kOwn][8], const bf16* __restrict__ src,
    const Thread<C, kBwd>& th, int r0, int N) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int at = 0; at < Tail<C, kBwd>::kOwn; ++at)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int row = r0 + th.row(r), col = th.col(at, nt);
        raw[r][at][nt] =
            row < N && col < C
                ? *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(row) * C + col)
                : 0u;
      }
}

// The block's start: the barriers, then the producer warp's loads; true
// for the consumer threads.
template <int C, bool kBwd>
__device__ __forceinline__ bool start_block(uint8_t* sm, const CUtensorMap* trows,
                                            const CUtensorMap* tdy,
                                            const CUtensorMap* tw1,
                                            const CUtensorMap* tw2, int r0) {
  using L = Tail<C, kBwd>;
  if (threadIdx.x == 0) {
    reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing)->init(1, kConsumers / 32);
    mbar_init(reinterpret_cast<uint64_t*>(sm + L::kRowsBar), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) produce<C, kBwd>(sm, trows, tdy, tw1, tw2, r0);
  return threadIdx.x < kConsumers;
}

template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_fwd_kernel(const __grid_constant__ CUtensorMap th_map,
                         const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2,
                         const bf16* __restrict__ x,
                         const bf16* __restrict__ lns,
                         const bf16* __restrict__ lnb,
                         const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                         const bf16* __restrict__ gamma, bf16* __restrict__ y,
                         int N, float eps) {
  using L = Tail<C, false>;
  constexpr int n = L::kChunks;
  uint8_t* sm = &aligned_smem<uint8_t>();
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  float* mu_s = reinterpret_cast<float*>(sm + L::kStats);
  float* rstd_s = mu_s + L::kRows;
  const int r0 = blockIdx.x * L::kRows;
  if (!start_block<C, false>(sm, &th_map, nullptr, &tw1, &tw2, r0)) return;

  mbar_wait(reinterpret_cast<uint64_t*>(sm + L::kRowsBar), 0);
  layer_norm_rows<C, L::kRows>(sm, mu_s, rstd_s, lns, lnb, eps);
  fence_proxy_async();
  named_barrier(1, kConsumers);

  const Thread<C, false> th;
  const uint32_t u = smem_u32(sm), w_base = smem_u32(sm + L::kW);
  auto tile = [&](int load) { return w_base + ring.stage(load) * L::kWTile; };
  float o[L::kOwn][32];
#pragma unroll
  for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[at][e] = 0.0f;

  // Chunk j: z = u·W1_jᵀ, a = bf16(gelu(z + b1)), o += a·W2_jᵀ. At C 384
  // a goes through exchange tile j % 2: a warpgroup writes it again only
  // after the barrier of chunk j + 1, which the other passes after the
  // products of chunk j that read it.
  if constexpr (!L::kSplit) {
    for (int j = 0; j < n; ++j) {
      float z[32];
      const uint32_t w1 = tile(2 * j), ua = opaque(u);
      ring.wait_full(2 * j);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss<0>(z, desc_k(a_rows<L::kRows>(ua, th.rg, ks)),
                    desc_k(w1 + (ks / 4) * kTileBytes + (ks % 4) * 32), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
      ring.release(2 * j);
      uint32_t af[4][4];  // a = gelu(z + b1)
      to_fragments(af, [&](int e, int col) {
        return gelu(z[e] + bf(b1, j * kChunk + col));
      }, th.t);
      const uint32_t w2 = tile(2 * j + 1);
      ring.wait_full(2 * j + 1);
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs<0>(o[at], af[ks], desc_k(w2 + at * kTileBytes + 32 * ks));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(af);
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at) fence_regs(o[at]);
      ring.release(2 * j + 1);
    }
  } else {
    for (int j = 0; j < n; ++j) {
      float z[16];
      const uint32_t w1 = tile(2 * j), ua = opaque(u);
      ring.wait_full(2 * j);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss_n32<0>(z, desc_k(a_rows<L::kRows>(ua, 0, ks)),
                        desc_k(w1 + (ks / 4) * kTileBytes + th.cg * 4096 +
                               (ks % 4) * 32),
                        ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
      ring.release(2 * j);
      uint8_t* act = sm + L::kAct + (j & 1) * kTileBytes;
      to_exchange(act, [&](int e, int col) {
        return gelu(z[e] + bf(b1, j * kChunk + col));
      }, th.cg * 32, th.row(0), th.t);
      named_barrier(1, kConsumers);
      const uint32_t a = smem_u32(act), w2 = tile(2 * j + 1);
      ring.wait_full(2 * j + 1);
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<0>(o[at], desc_k(a + 32 * ks),
                      desc_k(w2 + (th.cg * L::kOwn + at) * kTileBytes + 32 * ks),
                      1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at) fence_regs(o[at]);
      ring.release(2 * j + 1);
    }
  }
  // x is read at once, ahead of the epilogue.
  uint32_t xr[2][L::kOwn][8];
  load_pairs<C, false>(xr, x, th, r0, N);

  // y = x + γ·(o + b2), rows below N, columns below C.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + th.row(r);
    if (row >= N) continue;
#pragma unroll
    for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = th.col(at, nt);
        if (col >= C) continue;
        const float2 xv = bf2(xr[r][at][nt]), gv = bf2(gamma + col),
                     bv = bf2(b2 + col);
        *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * C + col) =
            pack_bf16x2(xv.x + gv.x * (o[at][4 * nt + 2 * r] + bv.x),
                        xv.y + gv.y * (o[at][4 * nt + 2 * r + 1] + bv.y));
      }
  }
}

template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_bwd_kernel(const __grid_constant__ CUtensorMap th_map,
                         const __grid_constant__ CUtensorMap tdy,
                         const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2,
                         const bf16* __restrict__ h,
                         const bf16* __restrict__ lns,
                         const bf16* __restrict__ lnb,
                         const bf16* __restrict__ b1,
                         const bf16* __restrict__ gamma, bf16* __restrict__ dh,
                         int N, float eps) {
  using L = Tail<C, true>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  float* mu_s = reinterpret_cast<float*>(sm + L::kStats);
  float* rstd_s = mu_s + L::kRows;
  float* sum1 = rstd_s + L::kRows;    // [2][kRows]: Σ dû per column half
  float* sum2 = sum1 + 2 * L::kRows;  // [2][kRows]: Σ dû·û
  const int r0 = blockIdx.x * L::kRows;
  if (!start_block<C, true>(sm, &th_map, &tdy, &tw1, &tw2, r0)) return;

  mbar_wait(reinterpret_cast<uint64_t*>(sm + L::kRowsBar), 0);
  layer_norm_rows<C, L::kRows>(sm, mu_s, rstd_s, lns, lnb, eps);
  // do = bf16(γ·dy) over the dy tile in place, 8 columns (one swizzled
  // 16-byte chunk) at a time; rows past N stay zeros.
  for (int i = threadIdx.x; i < L::kRows * (C / 8); i += kConsumers) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    uint4* p = reinterpret_cast<uint4*>(sm + L::kDo + sw_offset(r, c, L::kRows));
    uint4 raw = *p;
    bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(__bfloat162float(v[e]) * bf(gamma, c + e));
    *p = raw;
  }
  fence_proxy_async();
  named_barrier(1, kConsumers);

  const Thread<C, true> th;
  const uint32_t u = smem_u32(sm), dout = smem_u32(sm + L::kDo);
  const uint32_t w_base = smem_u32(sm + L::kW);
  float du[L::kOwn][32];
#pragma unroll
  for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) du[at][e] = 0.0f;

  for (int j = 0; j < L::kChunks; ++j) {
    const int f0 = j * kChunk;
    const uint32_t w2 = w_base + ring.stage(2 * j) * L::kWTile;
    const uint32_t w1 = w_base + ring.stage(2 * j + 1) * L::kWTile;
    const uint32_t ua = opaque(u), da_a = opaque(dout);
    if constexpr (!L::kSplit) {
      float da[32], z[32];
      ring.wait_full(2 * j);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss<1>(da, desc_k(a_rows<L::kRows>(da_a, th.rg, ks)),
                    desc_mn(w2 + 2048 * ks), ks > 0);
      wgmma_commit();
      ring.wait_full(2 * j + 1);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss<0>(z, desc_k(a_rows<L::kRows>(ua, th.rg, ks)),
                    desc_k(w1 + (ks / 4) * kTileBytes + (ks % 4) * 32), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(da);
      fence_regs(z);
      ring.release(2 * j);
      uint32_t af[4][4];  // dz = da·gelu′(z + b1)
      to_fragments(af, [&](int e, int col) {
        return da[e] * gelu_grad(z[e] + bf(b1, f0 + col));
      }, th.t);
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs<1>(du[at], af[ks], desc_mn(w1 + at * kTileBytes + 2048 * ks));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(af);
    } else {
      float da[16], z[16];
      ring.wait_full(2 * j);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss_n32<1>(da, desc_k(a_rows<L::kRows>(da_a, 0, ks)),
                        desc_mn(w2 + 2048 * ks + 64 * th.cg), ks > 0);
      wgmma_commit();
      ring.wait_full(2 * j + 1);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wgmma_ss_n32<0>(z, desc_k(a_rows<L::kRows>(ua, 0, ks)),
                        desc_k(w1 + (ks / 4) * kTileBytes + th.cg * 4096 +
                               (ks % 4) * 32),
                        ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(da);
      fence_regs(z);
      ring.release(2 * j);
      uint8_t* act = sm + L::kAct + (j & 1) * kTileBytes;
      to_exchange(act, [&](int e, int col) {
        return da[e] * gelu_grad(z[e] + bf(b1, f0 + col));
      }, th.cg * 32, th.row(0), th.t);
      named_barrier(1, kConsumers);
      const uint32_t a = smem_u32(act);
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<1>(du[at], desc_k(a + 32 * ks),
                      desc_mn(w1 + (th.cg * L::kOwn + at) * kTileBytes +
                              2048 * ks),
                      1);
      wgmma_commit();
      wgmma_wait<0>();
    }
#pragma unroll
    for (int at = 0; at < L::kOwn; ++at) fence_regs(du[at]);
    ring.release(2 * j + 1);
  }

  // LN backward. A row's columns are spread over the 4 threads of a group
  // and, at C 384, over both warpgroups: per-row sums of dû and dû·û go
  // through shuffles, then shared memory. h is read once, at once.
  uint32_t hr[2][L::kOwn][8];
  load_pairs<C, true>(hr, h, th, r0, N);
  constexpr int kHalves = L::kSplit ? 2 : 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = th.row(r);
    const float mu = mu_s[lr], rstd = rstd_s[lr];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = th.col(at, nt);
        if (col >= C) continue;
        const float2 hv = bf2(hr[r][at][nt]), sv = bf2(lns + col);
        const float d0 = du[at][4 * nt + 2 * r] * sv.x;
        const float d1 = du[at][4 * nt + 2 * r + 1] * sv.y;
        s1 += d0;
        s1 += d1;
        s2 += d0 * ((hv.x - mu) * rstd);
        s2 += d1 * ((hv.y - mu) * rstd);
      }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    if (th.t == 0) {
      sum1[th.cg * L::kRows + lr] = s1;
      sum2[th.cg * L::kRows + lr] = s2;
    }
  }
  named_barrier(1, kConsumers);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = th.row(r), row = r0 + lr;
    if (row >= N) continue;
    const float mu = mu_s[lr], rstd = rstd_s[lr];
    float c1 = sum1[lr], c2 = sum2[lr];
    if (kHalves == 2) {
      c1 += sum1[L::kRows + lr];
      c2 += sum2[L::kRows + lr];
    }
    c1 /= C;
    c2 /= C;
#pragma unroll
    for (int at = 0; at < L::kOwn; ++at)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = th.col(at, nt);
        if (col >= C) continue;
        const float2 hv = bf2(hr[r][at][nt]), sv = bf2(lns + col);
        const float u0 = (hv.x - mu) * rstd, u1 = (hv.y - mu) * rstd;
        const float d0 = du[at][4 * nt + 2 * r] * sv.x;
        const float d1 = du[at][4 * nt + 2 * r + 1] * sv.y;
        *reinterpret_cast<uint32_t*>(dh + static_cast<size_t>(row) * C + col) =
            pack_bf16x2(rstd * (d0 - c1 - u0 * c2), rstd * (d1 - c1 - u1 * c2));
      }
  }
}

// The tensor maps of the rows (and dy) and of both weights: boxes of 64 x 64.
template <int C>
int weight_maps(CUtensorMap* tw1, CUtensorMap* tw2, const void* w1,
                const void* w2) {
  const int err = matrix_map(tw1, w1, 4 * C, C);
  return err ? err : matrix_map(tw2, w2, C, 4 * C);
}

template <int C>
int launch_fwd(const void* h, const void* x, const void* lns, const void* lnb,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* gamma, void* y, int N, float eps,
               cudaStream_t stream) {
  using L = Tail<C, false>;
  CUtensorMap th, tw1, tw2;
  int err = matrix_map(&th, h, N, C);
  if (!err) err = weight_maps<C>(&tw1, &tw2, w1, w2);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      convnext_tail_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes));
  if (err) return err;
  convnext_tail_fwd_kernel<C>
      <<<(N + L::kRows - 1) / L::kRows, kBlockThreads, L::kBytes, stream>>>(
          th, tw1, tw2, static_cast<const bf16*>(x),
          static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
          static_cast<const bf16*>(gamma), static_cast<bf16*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_bwd(const void* h, const void* dy, const void* lns, const void* lnb,
               const void* w1, const void* b1, const void* w2,
               const void* gamma, void* dh, int N, float eps,
               cudaStream_t stream) {
  using L = Tail<C, true>;
  CUtensorMap th, tdy, tw1, tw2;
  int err = matrix_map(&th, h, N, C);
  if (!err) err = matrix_map(&tdy, dy, N, C);
  if (!err) err = weight_maps<C>(&tw1, &tw2, w1, w2);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      convnext_tail_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes));
  if (err) return err;
  convnext_tail_bwd_kernel<C>
      <<<(N + L::kRows - 1) / L::kRows, kBlockThreads, L::kBytes, stream>>>(
          th, tdy, tw1, tw2, static_cast<const bf16*>(h),
          static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(gamma),
          static_cast<bf16*>(dh), N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of K3 (bwd 0) or K4 (bwd 1) at width C, bytes, or 0
// for another C (for the build report).
extern "C" int convnext_tail_smem(int C, int bwd) {
  switch (C) {
    case 96: return bwd ? Tail<96, true>::kBytes : Tail<96, false>::kBytes;
    case 192: return bwd ? Tail<192, true>::kBytes : Tail<192, false>::kBytes;
    case 384: return bwd ? Tail<384, true>::kBytes : Tail<384, false>::kBytes;
    default: return 0;
  }
}

// h, x, y: (N, C) bf16; lns, lnb, b2, gamma: (C,) bf16; w1: (4C, C) bf16;
// b1: (4C,) bf16; w2: (C, 4C) bf16. All contiguous and 16-byte aligned.
// C in {96, 192, 384}. Returns cudaGetLastError() after the launch, the
// error of building a tensor map, or cudaErrorInvalidValue for another C.
extern "C" int convnext_tail_fwd(const void* h, const void* x, const void* lns,
                                 const void* lnb, const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* gamma, void* y, int N, int C,
                                 float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_fwd<96>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    case 192: return launch_fwd<192>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    case 384: return launch_fwd<384>(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// h, dy, dh: (N, C) bf16; w1: (4C, C), w2: (C, 4C) bf16; lns, lnb, gamma:
// (C,) bf16; b1: (4C,) bf16. C in {96, 192, 384}. Returns as
// convnext_tail_fwd.
extern "C" int convnext_tail_bwd(const void* h, const void* dy, const void* lns,
                                 const void* lnb, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* gamma, void* dh, int N, int C,
                                 float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd<96>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    case 192: return launch_bwd<192>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    case 384: return launch_bwd<384>(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
