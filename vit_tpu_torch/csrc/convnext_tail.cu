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
//
// K3's fp32 form (kParts = 3, the entry convnext_tail_f32_fwd) replaces
// _fwd_kernel on fp32 rows, where it takes both products at
// Precision.HIGHEST (:93): the TPU's six bf16 passes, here six bf16 wgmma
// products an fp32 product (hopper.cuh:mma_abt_parts_n32, mma_abt_parts,
// mma_rbt_parts; small terms first), with no bf16 rounding of u or a.
// convnext_tail_split first writes W1 and W2 as three bf16 parts each
// (x = x0 + x1 + x2 exactly) into scratch of the call, read through
// tensor maps of (3, rows, cols). The
// LN pass reads fp32 h from device memory (two-pass statistics) and writes
// u's three parts into shared memory as TMA's swizzle would; the producer
// streams each chunk's W1, then W2, by 64 x 64 atoms of three parts (24 KB
// a ring stage: a whole-C tile in three parts, 144 KB at C 384, does not
// fit beside u's 144 KB), and each stage feeds both warpgroups at once.
// C 192, 384: 64 rows a block; the warpgroups split every product's
// output columns in n32 halves: z's half (over C's atoms), then a =
// gelu(z + b1), split into three parts in a shared exchange tile (two at
// C 192, one at C 384 with a barrier before it is rewritten), then o's
// half of each atom (a·W2ᵀ). C 96: 128 rows, a warpgroup per 64 at the
// full width (n64), a split into three parts of register A fragments, as
// the bf16 kernel does; C 96's last atom of z takes its 32 columns only,
// and o's columns past C multiply TMA's zeros. Each atom's product goes
// into a fresh accumulator added to the sum in registers
// (hopper.cuh:484-495), two in turn where registers allow (C 192, and o at
// C 384; one at a time for z at C 384 and at C 96, within the 168
// registers of nine warps). The epilogue is the bf16 one in fp32.
// Bound: 16·C²·N FLOP at 989/6 TFLOP/s (29.6 GFLOP at ConvNeXt-S's three
// fused stages, 0.180 ms), far above its bytes; every block reads the
// weights' parts (48·C² bytes) from L2.
//
// K4's fp32 form (kParts = 3, the entry convnext_tail_f32_bwd) replaces
// _bwd_kernel on fp32 rows at Precision.HIGHEST (:117) the same way, after
// the same pre-split: 64 rows a block at every width, the warpgroups on the
// n32 halves of every product (SplitBwd): da = do·W2 (W2's atoms MN-major),
// z = u·W1ᵀ (W1's atoms K-major), dz = da⊙gelu′(z + b1) split into three
// parts in an exchange tile, du += dz·W1 (W1's atoms MN-major), each
// atom's six products in a fresh accumulator. An LN pass over fp32 h and
// dy writes u's and do = γ⊙dy's three parts, never rounded to bf16, and
// keeps the row statistics for the LN backward. Shared memory is the trap
// at C 384: u's and do's parts for 64 rows (2 x 147,456 B) pass the 227 KB
// a block may use, so there a pre-pass (convnext_tail_gz_kernel: u's parts
// and a ring of W1's atoms) writes gelu′(z + b1) to device memory (N x 4C
// fp32, written and read once: 0.046 ms of bytes at ConvNeXt-S's C 384) and
// the kernel holds do's parts alone. C 96 keeps W1's atoms in the ring from
// z to du; C 192, whose two-stage ring cannot hold its three, loads them
// again. Bound: 24·C²·N FLOP at 989/6 TFLOP/s (0.269 ms at ConvNeXt-S's
// fused stages).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The fp32 forward's tiling (kParts = 3) at width C: u as three bf16 parts
// in shared memory, W1 and W2 streamed by 64 x 64 atoms of three parts
// (24 KB a ring stage). C 192, 384 (kSplit): 64 rows a block, the
// warpgroups split the output columns, a's three parts in one or two
// exchange tiles (two where they leave the ring three stages or more).
// C 96: 128 rows, a warpgroup per 64 of them at the full width, a in
// register fragments.
template <int C>
struct SplitTail {
  static constexpr int kAtoms = (C + 63) / 64;
  static constexpr bool kSplit = C > 96;
  static constexpr int kRows = kSplit ? 64 : 128;
  static constexpr int kChunks = 4 * C / kChunk;
  static constexpr int kUPart = kAtoms * kRows * 128;
  static constexpr int kStage = 3 * static_cast<int>(kTileBytes);
  static constexpr int kActBufs =
      !kSplit ? 0
      : (kSmemLimit - kSmall - 3 * kUPart - 2 * kStage) / kStage >= 3 ? 2 : 1;
  // Byte offsets: u's parts, the exchange tiles, the ring, the small region
  static constexpr int kAct = 3 * kUPart;
  static constexpr int kW = kAct + kActBufs * kStage;
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kW + kStages * kStage;
  static constexpr int kBytes = kRing + kSmall + 1024;
  // Ring loads a chunk: W1's atoms (its 64 rows by 64 columns of C), then
  // W2's (64 rows of C by the chunk's 64 columns)
  static constexpr int kLoads = 2 * kAtoms;
  // k16 steps of z's last atom (C 96: 2, the columns that exist)
  static constexpr int kLastSteps = C % 64 ? (C % 64) / 16 : 4;
  static_assert(C % 32 == 0 && C <= 384, "C a multiple of 32, at most 384");
  static_assert(kStages >= 2, "two atoms in flight");
  static_assert(sizeof(Ring<kStages>) <= 128, "the ring's barriers");
};

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
// c0 + 31 of the chunk), rounded to bf16 (kParts = 1) or split into three
// bf16 parts (kParts = 3, part p kTileBytes after part p − 1), into the
// swizzled 64 x 64 exchange tile `act`; then the fence that lets a wgmma
// read it. The caller meets the other warpgroup after it.
template <int kParts = 1, typename F>
__device__ __forceinline__ void to_exchange(uint8_t* act, F f, int c0,
                                            int row0, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = 4 * nt + 2 * r;
      float lo = f(e, col), hi = f(e + 1, col + 1);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        *reinterpret_cast<__nv_bfloat162*>(
            act + p * kTileBytes + sw_offset(row0 + 8 * r, col, 64)) = v;
        if (p + 1 < kParts) {
          lo = __fsub_rn(lo, __low2float(v));
          hi = __fsub_rn(hi, __high2float(v));
        }
      }
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

// ---- the fp32 forward (kParts = 3) --------------------------------------

// x split into three bf16 parts (x = x0 + x1 + x2 exactly) at byte offset
// off of `base`, part p kPart bytes after part p − 1.
template <int kPart>
__device__ __forceinline__ void put_parts(uint8_t* base, int off, float x) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const bf16 part = __float2bfloat16(x);
    *reinterpret_cast<bf16*>(base + p * kPart + off) = part;
    x = __fsub_rn(x, __bfloat162float(part));
  }
}

// LayerNorm of the block's kRows rows of fp32 h, read from device memory:
// two-pass fp32 statistics and u = û·ln_scale + ln_bias in fp32 (no bf16
// rounding), split into three bf16 parts written to `u` as TMA's 128-byte
// swizzle would place them, part p kPart bytes after part p − 1 (C 96:
// the last atom's columns past C are never read), and the statistics into
// mu_s and rstd_s; a null u or mu_s skips those writes. Rows past N read h
// as zeros (u = ln_bias: finite, never stored). Each consumer warp takes
// kRows / 8 rows, all of them read before any is reduced.
template <int C, int kRows, int kPart>
__device__ __forceinline__ void layer_norm_parts(uint8_t* u, float* mu_s,
                                                 float* rstd_s,
                                                 const float* __restrict__ h,
                                                 const float* __restrict__ lns,
                                                 const float* __restrict__ lnb,
                                                 int r0, int N, float eps) {
  constexpr int kPer = kRows / (kConsumers / 32), kV = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v[kPer][kV];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = r0 + warp * kPer + i;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      v[i][j] = row < N ? h[static_cast<size_t>(row) * C + lane + 32 * j]
                        : 0.0f;
  }
  float sc[kV], bi[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sc[j] = lns[lane + 32 * j];
    bi[j] = lnb[lane + 32 * j];
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
    if (u != nullptr) {
#pragma unroll
      for (int j = 0; j < kV; ++j)
        // û·ln_scale, then + ln_bias: the plain version's two roundings
        put_parts<kPart>(u, sw_offset(r, lane + 32 * j, kRows),
                         __fadd_rn(__fmul_rn(v[i][j] * rstd, sc[j]), bi[j]));
    }
    if (mu_s != nullptr && lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
}

// The fp32 form's producer: every chunk's W1 atoms, then its W2 atoms, each
// as its three parts (three 64 x 64 boxes of the parts' tensor maps) into
// one ring stage, as soon as the stage is free.
template <int C>
__device__ __forceinline__ void produce_parts(uint8_t* sm,
                                              const CUtensorMap* tw1,
                                              const CUtensorMap* tw2) {
  using L = SplitTail<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  for (int i = 0; i < L::kLoads * L::kChunks; ++i) {
    const int f0 = (i / L::kLoads) * kChunk, k = i % L::kLoads;
    const int st = ring.stage(i);
    uint8_t* dst = sm + L::kW + st * L::kStage;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], L::kStage);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (k < L::kAtoms)
        tma_load_4d(dst + p * kTileBytes, tw1, &ring.full[st], 64 * k, f0, p, 0);
      else
        tma_load_4d(dst + p * kTileBytes, tw2, &ring.full[st], f0,
                    64 * (k - L::kAtoms), p, 0);
    }
  }
}

// d += tile in registers, rounded to nearest (attention_tile.cuh:head_rb_into).
template <int N>
__device__ __forceinline__ void add_tile(float (&d)[N], const float (&tile)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = __fadd_rn(d[e], tile[e]);
}

// The ring loads i0 .. i0 + kAtoms − 1, one 64 x 64 atom of three parts
// each, against A_b at a + b·a_step (its parts a_part apart): the products
// A_b·B_bᵀ (64 x 32, six bf16 wgmma products an atom,
// hopper.cuh:mma_abt_parts_n32) with B_b the n32 half `half` of atom b's
// tile, over the atom's first 16·kLastSteps columns for the last atom,
// summed over the atoms into d[0] (kOut 1: z over C) or each into its own
// d[b] (kOut kAtoms: o's atoms over a chunk). kTransB 1 reads B_b MN-major
// (hopper.cuh:mma_ab_parts_n32: its rows the reduction, the half 64 bytes
// into its rows), for da = do·W2 and du += dz·W1. Each atom's product goes
// into a fresh accumulator; with kBufs 2 two take turns, so one atom's
// products run while the last one's are added to d. A stage is released
// once its products are done, unless kRelease is false (a later product
// reads it again and releases it).
template <int kStages, int kAtoms, int kBufs, int kLastSteps, int kOut,
          int kTransB = 0, bool kRelease = true>
__device__ __forceinline__ void sum_atoms(float (&d)[kOut][16],
                                          Ring<kStages>& ring, int i0,
                                          uint32_t w_base, uint32_t a,
                                          uint32_t a_step, uint32_t a_part,
                                          int half) {
  static_assert(kOut == 1 || kOut == kAtoms, "one sum, or one an atom");
  constexpr uint32_t kStage = 3 * kTileBytes;
  float f[kBufs][16];
#pragma unroll
  for (int b = 0; b < kAtoms; ++b) {
    const uint32_t w = w_base + ring.stage(i0 + b) * kStage +
                       half * (kTransB ? 64 : 4096);
    const uint32_t ab = opaque(a) + b * a_step;
    ring.wait_full(i0 + b);
    wgmma_fence();
    constexpr int kLast = kLastSteps;
    if constexpr (kTransB) {
      if (b < kAtoms - 1)
        mma_ab_parts_n32<3>(f[b % kBufs], ab, a_part, w, kTileBytes);
      else
        mma_ab_parts_n32<3, kLast>(f[b % kBufs], ab, a_part, w, kTileBytes);
    } else {
      if (b < kAtoms - 1)
        mma_abt_parts_n32<3>(f[b % kBufs], ab, a_part, w, kTileBytes);
      else
        mma_abt_parts_n32<3, kLast>(f[b % kBufs], ab, a_part, w, kTileBytes);
    }
    wgmma_commit();
    if (kBufs == 1 || b > 0) {
      const int done = kBufs == 1 ? b : b - 1;
      wgmma_wait<kBufs - 1>();
      fence_regs(f[done % kBufs]);
      add_tile(d[kOut == 1 ? 0 : done], f[done % kBufs]);
      if (kRelease) ring.release(i0 + done);
    }
  }
  if (kBufs == 2) {
    wgmma_wait<0>();
    fence_regs(f[(kAtoms - 1) % 2]);
    add_tile(d[kOut == 1 ? 0 : kAtoms - 1], f[(kAtoms - 1) % 2]);
    if (kRelease) ring.release(i0 + kAtoms - 1);
  }
}

// y = x + γ·(o + b2) at (row, col) and (row, col + 1), fp32, when col < C.
template <int C>
__device__ __forceinline__ void store_y(const float* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ b2,
                                        float* __restrict__ y, int row, int col,
                                        float o0, float o1) {
  if (col >= C) return;
  const size_t i = static_cast<size_t>(row) * C + col;
  const float2 xv = *reinterpret_cast<const float2*>(x + i);
  const float2 gv = *reinterpret_cast<const float2*>(gamma + col);
  const float2 bv = *reinterpret_cast<const float2*>(b2 + col);
  *reinterpret_cast<float2*>(y + i) =
      make_float2(xv.x + gv.x * (o0 + bv.x), xv.y + gv.y * (o1 + bv.y));
}

// C 192, 384: warpgroup wg forms columns 32·wg .. 32·wg + 31 of each
// chunk's z and of each 64-column atom of o, over the block's 64 rows;
// y = x + γ·(o + b2) from them.
template <int C>
__device__ __forceinline__ void tail_parts_split(
    uint8_t* sm, const float* __restrict__ x, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    float* __restrict__ y, int r0, int N) {
  using L = SplitTail<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint32_t u = smem_u32(sm), w_base = smem_u32(sm + L::kW);
  float o[L::kAtoms][16];
#pragma unroll
  for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[at][e] = 0.0f;

  // Chunk j: z = u·W1_jᵀ over the atoms of C; a = gelu(z + b1) in three
  // parts into exchange tile j % kActBufs; o += a·W2_jᵀ atom by atom.
  for (int j = 0; j < L::kChunks; ++j) {
    const int i0 = j * L::kLoads;
    float z[1][16];
#pragma unroll
    for (int e = 0; e < 16; ++e) z[0][e] = 0.0f;
    // z's fresh accumulators two in turn at C 192, one at C 384 (two
    // spilled there)
    sum_atoms<L::kStages, L::kAtoms, (C > 192 ? 1 : 2), L::kLastSteps>(
        z, ring, i0, w_base, u, kTileBytes, L::kUPart, wg);
    uint8_t* act = sm + L::kAct + (j % L::kActBufs) * L::kStage;
    // With one exchange tile, both warpgroups must be done with chunk
    // j − 1's products before either writes chunk j's a.
    if (L::kActBufs == 1) named_barrier(2, kConsumers);
    to_exchange<3>(act, [&](int e, int col) {
      return gelu(z[0][e] + b1[j * kChunk + col]);
    }, wg * 32, warp * 16 + g, t);
    named_barrier(1, kConsumers);
    sum_atoms<L::kStages, L::kAtoms, 2, 4>(o, ring, i0 + L::kAtoms, w_base,
                                          smem_u32(act), 0, kTileBytes, wg);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store_y<C>(x, gamma, b2, y, row, at * 64 + wg * 32 + nt * 8 + 2 * t,
                o[at][4 * nt + 2 * r], o[at][4 * nt + 2 * r + 1]);
  }
}

// C 96: warpgroup wg takes the block's rows 64·wg .. 64·wg + 63 at the full
// width: each chunk's z (n64) over C's two atoms (the second 32 columns
// wide), a = gelu(z + b1) split into three parts of register A fragments,
// then o += a·W2ᵀ atom by atom (the second atom's columns past C multiply
// TMA's zeros). One fresh accumulator at a time: o, a's parts and two
// would pass the 168 registers of nine warps.
template <int C>
__device__ __forceinline__ void tail_parts_rows(
    uint8_t* sm, const float* __restrict__ x, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    float* __restrict__ y, int r0, int N) {
  using L = SplitTail<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint32_t u = smem_u32(sm) + wg * kTileBytes;
  const uint32_t w_base = smem_u32(sm + L::kW);
  auto stage = [&](int i) { return w_base + ring.stage(i) * L::kStage; };
  float o[L::kAtoms][32], f[32];
#pragma unroll
  for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[at][e] = 0.0f;

  for (int j = 0; j < L::kChunks; ++j) {
    const int i0 = j * L::kLoads;
    float z[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) z[e] = 0.0f;
#pragma unroll
    for (int b = 0; b < L::kAtoms; ++b) {
      const uint32_t w = stage(i0 + b), ub = opaque(u) + b * L::kRows * 128;
      ring.wait_full(i0 + b);
      wgmma_fence();
      if (b < L::kAtoms - 1)
        mma_abt_parts<3>(f, ub, L::kUPart, w, kTileBytes);
      else
        mma_abt_parts<3, L::kLastSteps>(f, ub, L::kUPart, w, kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(f);
      add_tile(z, f);
      ring.release(i0 + b);
    }
    uint32_t af[3][4][4];  // a = gelu(z + b1), three parts
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = j * kChunk + nt * 8 + 2 * t;
      const float c0 = b1[col], c1 = b1[col + 1];
      put_a<3>(af, nt / 2, (nt % 2) * 2, gelu(z[4 * nt] + c0),
               gelu(z[4 * nt + 1] + c1));
      put_a<3>(af, nt / 2, (nt % 2) * 2 + 1, gelu(z[4 * nt + 2] + c0),
               gelu(z[4 * nt + 3] + c1));
    }
#pragma unroll
    for (int at = 0; at < L::kAtoms; ++at) {
      const int i = i0 + L::kAtoms + at;
      const uint32_t w = stage(i);
#pragma unroll
      for (int e = 0; e < 32; ++e) f[e] = 0.0f;
      ring.wait_full(i);
      wgmma_fence();
      mma_rbt_parts<3>(f, af, w, kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(f);
      fence_regs(af);
      add_tile(o[at], f);
      ring.release(i);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store_y<C>(x, gamma, b2, y, row, at * 64 + nt * 8 + 2 * t,
                o[at][4 * nt + 2 * r], o[at][4 * nt + 2 * r + 1]);
  }
}

// K3 on fp32 rows: the ring, the producer warp, the LayerNorm of the
// block's rows into u's parts, then the products (tail_parts_split at
// C 192 and 384, tail_parts_rows at C 96).
template <int C>
__device__ __forceinline__ void tail_fwd_parts(
    const CUtensorMap* tw1, const CUtensorMap* tw2, const float* __restrict__ h,
    const float* __restrict__ x, const float* __restrict__ lns,
    const float* __restrict__ lnb, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    float* __restrict__ y, int N, float eps) {
  using L = SplitTail<C>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  const int r0 = blockIdx.x * L::kRows;
  if (threadIdx.x == 0) {
    reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing)->init(1, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) produce_parts<C>(sm, tw1, tw2);
  if (threadIdx.x >= kConsumers) return;

  layer_norm_parts<C, L::kRows, L::kUPart>(sm, nullptr, nullptr, h, lns, lnb,
                                         r0, N, eps);
  fence_proxy_async();
  named_barrier(1, kConsumers);
  if constexpr (L::kSplit)
    tail_parts_split<C>(sm, x, b1, b2, gamma, y, r0, N);
  else
    tail_parts_rows<C>(sm, x, b1, b2, gamma, y, r0, N);
}

// The row type of K3's kParts form: bf16, or fp32 for kParts = 3
template <int kParts>
using RowT = std::conditional_t<kParts == 1, bf16, float>;

// K3. kParts = 1: bf16 rows through the tensor map of h; kParts = 3: fp32
// rows h (tail_fwd_parts), W1 and W2 through the tensor maps of their three
// bf16 parts.
template <int C, int kParts>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_fwd_kernel(const __grid_constant__ CUtensorMap th_map,
                         const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2,
                         const RowT<kParts>* __restrict__ x,
                         const RowT<kParts>* __restrict__ lns,
                         const RowT<kParts>* __restrict__ lnb,
                         const RowT<kParts>* __restrict__ b1,
                         const RowT<kParts>* __restrict__ b2,
                         const RowT<kParts>* __restrict__ gamma,
                         RowT<kParts>* __restrict__ y, int N, float eps,
                         const RowT<kParts>* __restrict__ h) {
  if constexpr (kParts == 3) {
    tail_fwd_parts<C>(&tw1, &tw2, h, x, lns, lnb, b1, b2, gamma, y, N, eps);
  } else {
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
}

// ---- the fp32 backward (kParts = 3) -------------------------------------

// The fp32 backward's tiling (kParts = 3) at width C: 64 rows a block, the
// warpgroups on the n32 halves of every product's output columns, as the
// fp32 forward's C 192 and 384 (SplitTail). do = γ⊙dy's three bf16 parts
// and, but at C 384, u's, each [part][atom][64 rows][128 B]; dz's three
// parts through one or two exchange tiles; W2 and W1 streamed by 64 x 64
// atoms of three parts (24 KB a ring stage). At C 384 u's and do's parts
// (2 x 147,456 B) do not fit together: z comes from a pre-pass
// (convnext_tail_gz_kernel, kGz) that writes gelu′(z + b1) to device
// memory, and this kernel holds do's parts alone. A chunk's W1 atoms stay
// in the ring from z to du where the ring holds them all (kHold: C 96);
// else they load again for du (C 192).
template <int C>
struct SplitBwd {
  static constexpr int kAtoms = (C + 63) / 64;
  static constexpr int kRows = 64;
  static constexpr int kChunks = 4 * C / kChunk;
  static constexpr bool kGz = C > 192;
  static constexpr int kPart = kAtoms * kRows * 128;
  static constexpr int kStage = 3 * static_cast<int>(kTileBytes);
  // Byte offsets: do's parts, u's parts (but at kGz), the exchange tiles,
  // the ring, the small region
  static constexpr int kU = 3 * kPart;
  static constexpr int kAct = kU + (kGz ? 0 : 3 * kPart);
  static constexpr int kActBufs =
      (kSmemLimit - kSmall - kAct - 2 * kStage) / kStage >= 3 ? 2 : 1;
  static constexpr int kW = kAct + kActBufs * kStage;
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr bool kHold = !kGz && kStages >= kAtoms;
  // Ring loads a chunk: W2's atoms (da), W1's (z, and du where held), W1's
  // again (du) where not held
  static constexpr int kLoads = kAtoms * (kGz || kHold ? 2 : 3);
  static constexpr int kRing = kW + kStages * kStage;
  static constexpr int kStats = kRing + 128;  // mu, rstd, Σdû[2], Σdû·û[2]
  static constexpr int kBytes = kRing + kSmall + 1024;
  // k16 steps of the last atom of C (C 96: 2, the columns that exist)
  static constexpr int kLastSteps = C % 64 ? (C % 64) / 16 : 4;
  static_assert(C % 32 == 0 && C <= 384, "C a multiple of 32, at most 384");
  static_assert(kStages >= 2, "two atoms in flight");
  static_assert(sizeof(Ring<kStages>) <= 128, "the ring's barriers");
  static_assert(128 + 6 * kRows * 4 <= kSmall, "the row statistics");
};

// The z pre-pass at C 384: u's three parts and a ring of W1's atoms.
template <int C>
struct SplitGz {
  static constexpr int kAtoms = (C + 63) / 64;
  static constexpr int kRows = 64;
  static constexpr int kChunks = 4 * C / kChunk;
  static constexpr int kPart = kAtoms * kRows * 128;
  static constexpr int kStage = 3 * static_cast<int>(kTileBytes);
  static constexpr int kW = 3 * kPart;
  static constexpr int kFit = (kSmemLimit - kW - kSmall) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRing = kW + kStages * kStage;
  static constexpr int kBytes = kRing + kSmall + 1024;
  static constexpr int kLastSteps = C % 64 ? (C % 64) / 16 : 4;
  static_assert(kStages >= 2, "two atoms in flight");
};

// do = γ⊙dy of the block's 64 rows of fp32 dy, read from device memory (one
// fp32 rounding, as the plain version), split into three bf16 parts written
// to `dst` as TMA's swizzle would place them, part p kPart bytes after part
// p − 1; rows past N are zeros. Each consumer warp takes 8 rows.
template <int C, int kPart>
__device__ __forceinline__ void scale_parts(uint8_t* dst,
                                            const float* __restrict__ dy,
                                            const float* __restrict__ gamma,
                                            int r0, int N) {
  constexpr int kPer = 64 / (kConsumers / 32), kV = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float gv[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) gv[j] = gamma[lane + 32 * j];
#pragma unroll 2
  for (int i = 0; i < kPer; ++i) {
    const int r = warp * kPer + i, row = r0 + r;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int col = lane + 32 * j;
      put_parts<kPart>(dst, sw_offset(r, col, 64),
                       row < N ? __fmul_rn(dy[static_cast<size_t>(row) * C + col], gv[j])
                               : 0.0f);
    }
  }
}

// z = u·W1ᵀ's n32 half wg of chunk j, for the block's 64 rows, as its
// thread holds it: the accumulator element e at (row 16·warp + g + 8·((e /
// 2) % 2), chunk column 32·wg + 8·(e / 4) + 2t + e % 2).
__device__ __forceinline__ int chunk_col(int j, int wg, int e, int t) {
  return j * kChunk + wg * 32 + (e / 4) * 8 + 2 * t + e % 2;
}

// The z pre-pass of K4's fp32 form where u's and do's parts do not fit
// together (C 384): u's parts from an LN pass over fp32 h, every chunk's z
// (the warpgroups on its n32 halves, six bf16 wgmma products an atom, each
// in a fresh accumulator) and gelu′(z + b1) written to gz (N, 4C) fp32.
template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_gz_kernel(const __grid_constant__ CUtensorMap tw1,
                        const float* __restrict__ h,
                        const float* __restrict__ lns,
                        const float* __restrict__ lnb,
                        const float* __restrict__ b1, float* __restrict__ gz,
                        int N, float eps) {
  using L = SplitGz<C>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  const int r0 = blockIdx.x * L::kRows;
  if (threadIdx.x == 0) {
    ring.init(1, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) {
    for (int i = 0; i < L::kAtoms * L::kChunks; ++i) {
      const int f0 = (i / L::kAtoms) * kChunk, b = i % L::kAtoms;
      const int st = ring.stage(i);
      uint8_t* dst = sm + L::kW + st * L::kStage;
      ring.wait_empty(i);
      mbar_arrive_expect_tx(&ring.full[st], L::kStage);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        tma_load_4d(dst + p * kTileBytes, &tw1, &ring.full[st], 64 * b, f0, p, 0);
    }
  }
  if (threadIdx.x >= kConsumers) return;

  layer_norm_parts<C, L::kRows, L::kPart>(sm, nullptr, nullptr, h, lns, lnb,
                                         r0, N, eps);
  fence_proxy_async();
  named_barrier(1, kConsumers);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint32_t w_base = smem_u32(sm + L::kW);
  for (int j = 0; j < L::kChunks; ++j) {
    float z[1][16];
#pragma unroll
    for (int e = 0; e < 16; ++e) z[0][e] = 0.0f;
    sum_atoms<L::kStages, L::kAtoms, 2, L::kLastSteps>(
        z, ring, j * L::kAtoms, w_base, smem_u32(sm), kTileBytes, L::kPart, wg);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + g + 8 * r;
      if (row >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = 4 * nt + 2 * r, col = chunk_col(j, wg, e, t);
        *reinterpret_cast<float2*>(gz + static_cast<size_t>(row) * 4 * C + col) =
            make_float2(gelu_grad(__fadd_rn(z[0][e], b1[col])),
                        gelu_grad(__fadd_rn(z[0][e + 1], b1[col + 1])));
      }
    }
  }
}

// The fp32 backward's producer: every chunk's W2 atoms, then its W1 atoms
// (once, or twice where not held: SplitBwd::kLoads), each as its three
// parts into one ring stage, as soon as the stage is free.
template <int C>
__device__ __forceinline__ void produce_bwd_parts(uint8_t* sm,
                                                  const CUtensorMap* tw1,
                                                  const CUtensorMap* tw2) {
  using L = SplitBwd<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  for (int i = 0; i < L::kLoads * L::kChunks; ++i) {
    const int f0 = (i / L::kLoads) * kChunk, k = i % L::kLoads;
    const int st = ring.stage(i);
    uint8_t* dst = sm + L::kW + st * L::kStage;
    ring.wait_empty(i);
    mbar_arrive_expect_tx(&ring.full[st], L::kStage);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (k < L::kAtoms)
        tma_load_4d(dst + p * kTileBytes, tw2, &ring.full[st], f0, 64 * k, p, 0);
      else
        tma_load_4d(dst + p * kTileBytes, tw1, &ring.full[st],
                    64 * ((k - L::kAtoms) % L::kAtoms), f0, p, 0);
    }
  }
}

// K4 on fp32 rows, after the LN and do passes: warpgroup wg forms columns
// 32·wg .. 32·wg + 31 of each chunk's da (do·W2 over C's atoms) and z
// (u·W1ᵀ, or gelu′(z + b1) read from gz at C 384), dz = da⊙gelu′(z + b1)
// split into three parts in an exchange tile, then the same half of each
// 64-column atom of du (dz·W1); then the LN backward with per-row Σdû and
// Σdû·û over both warpgroups' columns.
template <int C>
__device__ __forceinline__ void tail_bwd_parts(
    uint8_t* sm, const float* __restrict__ h, const float* __restrict__ lns,
    const float* __restrict__ b1, const float* __restrict__ gz,
    float* __restrict__ dh, int r0, int N) {
  using L = SplitBwd<C>;
  Ring<L::kStages>& ring = *reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing);
  const float* mu_s = reinterpret_cast<const float*>(sm + L::kStats);
  const float* rstd_s = mu_s + 64;
  float* sum1 = reinterpret_cast<float*>(sm + L::kStats) + 128;  // [2][64]
  float* sum2 = sum1 + 128;                                       // [2][64]
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint32_t w_base = smem_u32(sm + L::kW);
  float du[L::kAtoms][16];
#pragma unroll
  for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
    for (int e = 0; e < 16; ++e) du[at][e] = 0.0f;

  for (int j = 0; j < L::kChunks; ++j) {
    const int i0 = j * L::kLoads;
    float da[1][16], gp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) da[0][e] = 0.0f;
    // da's fresh accumulators two in turn, one at C 384 (du's 96 registers)
    sum_atoms<L::kStages, L::kAtoms, (L::kGz ? 1 : 2), L::kLastSteps, 1, 1>(
        da, ring, i0, w_base, smem_u32(sm), kTileBytes, L::kPart, wg);
    if constexpr (L::kGz) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + g + 8 * r;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int e = 4 * nt + 2 * r;
          const float2 v = row < N
              ? *reinterpret_cast<const float2*>(
                    gz + static_cast<size_t>(row) * 4 * C + chunk_col(j, wg, e, t))
              : make_float2(0.0f, 0.0f);
          gp[e] = v.x;
          gp[e + 1] = v.y;
        }
      }
    } else {
      float z[1][16];
#pragma unroll
      for (int e = 0; e < 16; ++e) z[0][e] = 0.0f;
      sum_atoms<L::kStages, L::kAtoms, 2, L::kLastSteps, 1, 0, !L::kHold>(
          z, ring, i0 + L::kAtoms, w_base, smem_u32(sm + L::kU), kTileBytes,
          L::kPart, wg);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        gp[e] = gelu_grad(__fadd_rn(z[0][e], b1[chunk_col(j, wg, e, t)]));
    }
    uint8_t* act = sm + L::kAct + (j % L::kActBufs) * L::kStage;
    // With one exchange tile, both warpgroups must be done with chunk
    // j − 1's du before either writes chunk j's dz.
    if (L::kActBufs == 1) named_barrier(2, kConsumers);
    to_exchange<3>(act, [&](int e, int) { return __fmul_rn(da[0][e], gp[e]); },
                   wg * 32, warp * 16 + g, t);
    named_barrier(1, kConsumers);
    sum_atoms<L::kStages, L::kAtoms, 2, 4, L::kAtoms, 1>(
        du, ring, i0 + L::kAtoms * (L::kGz || L::kHold ? 1 : 2), w_base,
        smem_u32(act), 0, kTileBytes, wg);
  }

  // LN backward: dû = du⊙lns; a row's columns are spread over the 4
  // threads of a group and both warpgroups.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + 8 * r, row = r0 + lr;
    const float mu = mu_s[lr], rstd = rstd_s[lr];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = at * 64 + wg * 32 + nt * 8 + 2 * t;
        if (col >= C) continue;
        const float2 hv = row < N
            ? *reinterpret_cast<const float2*>(h + static_cast<size_t>(row) * C + col)
            : make_float2(0.0f, 0.0f);
        const float d0 = __fmul_rn(du[at][4 * nt + 2 * r], lns[col]);
        const float d1 = __fmul_rn(du[at][4 * nt + 2 * r + 1], lns[col + 1]);
        s1 += d0;
        s1 += d1;
        s2 += d0 * ((hv.x - mu) * rstd);
        s2 += d1 * ((hv.y - mu) * rstd);
      }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    if (t == 0) {
      sum1[wg * 64 + lr] = s1;
      sum2[wg * 64 + lr] = s2;
    }
  }
  named_barrier(1, kConsumers);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + 8 * r, row = r0 + lr;
    if (row >= N) continue;
    const float mu = mu_s[lr], rstd = rstd_s[lr];
    const float c1 = (sum1[lr] + sum1[64 + lr]) / C;
    const float c2 = (sum2[lr] + sum2[64 + lr]) / C;
#pragma unroll
    for (int at = 0; at < L::kAtoms; ++at)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = at * 64 + wg * 32 + nt * 8 + 2 * t;
        if (col >= C) continue;
        const size_t i = static_cast<size_t>(row) * C + col;
        const float2 hv = *reinterpret_cast<const float2*>(h + i);
        const float u0 = (hv.x - mu) * rstd, u1 = (hv.y - mu) * rstd;
        const float d0 = __fmul_rn(du[at][4 * nt + 2 * r], lns[col]);
        const float d1 = __fmul_rn(du[at][4 * nt + 2 * r + 1], lns[col + 1]);
        *reinterpret_cast<float2*>(dh + i) =
            make_float2(rstd * (d0 - c1 - u0 * c2), rstd * (d1 - c1 - u1 * c2));
      }
  }
}

// K4 on fp32 rows: the ring, the producer warp, the LN pass (u's parts but
// at C 384, the statistics) and do's parts, then tail_bwd_parts.
template <int C>
__device__ __forceinline__ void tail_bwd_f32(
    const CUtensorMap* tw1, const CUtensorMap* tw2, const float* __restrict__ h,
    const float* __restrict__ dy, const float* __restrict__ lns,
    const float* __restrict__ lnb, const float* __restrict__ b1,
    const float* __restrict__ gamma, const float* __restrict__ gz,
    float* __restrict__ dh, int N, float eps) {
  using L = SplitBwd<C>;
  uint8_t* sm = &aligned_smem<uint8_t>();
  const int r0 = blockIdx.x * L::kRows;
  if (threadIdx.x == 0) {
    reinterpret_cast<Ring<L::kStages>*>(sm + L::kRing)->init(1, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) produce_bwd_parts<C>(sm, tw1, tw2);
  if (threadIdx.x >= kConsumers) return;

  float* mu_s = reinterpret_cast<float*>(sm + L::kStats);
  layer_norm_parts<C, L::kRows, L::kPart>(L::kGz ? nullptr : sm + L::kU, mu_s,
                                         mu_s + 64, h, lns, lnb, r0, N, eps);
  scale_parts<C, L::kPart>(sm, dy, gamma, r0, N);
  fence_proxy_async();
  named_barrier(1, kConsumers);
  tail_bwd_parts<C>(sm, h, lns, b1, gz, dh, r0, N);
}

// K4. kParts = 1: bf16 rows h and dy through their tensor maps; kParts =
// 3: fp32 rows h and dy read from device memory (tail_bwd_f32), W1 and W2
// through the tensor maps of their three bf16 parts, gz the z pre-pass's
// output at C 384.
template <int C, int kParts>
__global__ void __launch_bounds__(kBlockThreads, 1)
convnext_tail_bwd_kernel(const __grid_constant__ CUtensorMap th_map,
                         const __grid_constant__ CUtensorMap tdy,
                         const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2,
                         const RowT<kParts>* __restrict__ h,
                         const RowT<kParts>* __restrict__ lns,
                         const RowT<kParts>* __restrict__ lnb,
                         const RowT<kParts>* __restrict__ b1,
                         const RowT<kParts>* __restrict__ gamma,
                         RowT<kParts>* __restrict__ dh, int N, float eps,
                         const RowT<kParts>* __restrict__ dy,
                         const float* __restrict__ gz) {
  if constexpr (kParts == 3) {
    tail_bwd_f32<C>(&tw1, &tw2, h, dy, lns, lnb, b1, gamma, gz, dh, N, eps);
  } else {
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
      convnext_tail_fwd_kernel<C, 1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  convnext_tail_fwd_kernel<C, 1>
      <<<(N + L::kRows - 1) / L::kRows, kBlockThreads, L::kBytes, stream>>>(
          th, tw1, tw2, static_cast<const bf16*>(x),
          static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
          static_cast<const bf16*>(gamma), static_cast<bf16*>(y), N, eps,
          nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The pre-split of the fp32 form: W1 (4C, C) and W2 (C, 4C), n = 4C² fp32
// values each, into parts (2, 3, n) bf16, weight w's part p at (w, p):
// x = x0 + x1 + x2 exactly (x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x −
// x0 − x1)), as attention_bwd.cu:split_parts_kernel splits its operands.
// A thread takes four neighbouring values: a 16-byte load, three 8-byte
// stores. Bound by its bytes: 4 read and 6 written a value.
__global__ void split_weights_kernel(const float* __restrict__ w1,
                                     const float* __restrict__ w2,
                                     bf16* __restrict__ parts, int n) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float* src = blockIdx.y == 0 ? w1 : w2;
  bf16* dst = parts + static_cast<size_t>(blockIdx.y) * 3 * n + i;
  float4 x = *reinterpret_cast<const float4*>(src + i);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + static_cast<size_t>(p) * n) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
    x.x = __fsub_rn(x.x, __low2float(lo));
    x.y = __fsub_rn(x.y, __high2float(lo));
    x.z = __fsub_rn(x.z, __low2float(hi));
    x.w = __fsub_rn(x.w, __high2float(hi));
  }
}

template <int C>
int launch_fwd_parts(const void* h, const void* x, const void* lns,
                     const void* lnb, const void* parts, const void* b1,
                     const void* b2, const void* gamma, void* y, int N,
                     float eps, cudaStream_t stream) {
  using L = SplitTail<C>;
  CUtensorMap th{}, tw1, tw2;
  const bf16* w1p = static_cast<const bf16*>(parts);
  int err = parts_map(&tw1, w1p, 4 * C, C);
  if (!err) err = parts_map(&tw2, w1p + 3 * 4 * C * C, C, 4 * C);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      convnext_tail_fwd_kernel<C, 3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  convnext_tail_fwd_kernel<C, 3>
      <<<(N + L::kRows - 1) / L::kRows, kBlockThreads, L::kBytes, stream>>>(
          th, tw1, tw2, static_cast<const float*>(x),
          static_cast<const float*>(lns), static_cast<const float*>(lnb),
          static_cast<const float*>(b1), static_cast<const float*>(b2),
          static_cast<const float*>(gamma), static_cast<float*>(y), N, eps,
          static_cast<const float*>(h));
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
      convnext_tail_bwd_kernel<C, 1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  convnext_tail_bwd_kernel<C, 1>
      <<<(N + L::kRows - 1) / L::kRows, kBlockThreads, L::kBytes, stream>>>(
          th, tdy, tw1, tw2, static_cast<const bf16*>(h),
          static_cast<const bf16*>(lns), static_cast<const bf16*>(lnb),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(gamma),
          static_cast<bf16*>(dh), N, eps, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K4's fp32 form: at C 384 the z pre-pass into gz (N, 4C), then the
// kernel on the parts the wrapper's pre-split wrote.
template <int C>
int launch_bwd_parts(const void* h, const void* dy, const void* lns,
                     const void* lnb, const void* parts, const void* b1,
                     const void* gamma, void* gz, void* dh, int N, float eps,
                     cudaStream_t stream) {
  using L = SplitBwd<C>;
  CUtensorMap th{}, tdy{}, tw1, tw2;
  const bf16* w1p = static_cast<const bf16*>(parts);
  int err = parts_map(&tw1, w1p, 4 * C, C);
  if (!err) err = parts_map(&tw2, w1p + 3 * 4 * C * C, C, 4 * C);
  if (err) return err;
  const int blocks = (N + L::kRows - 1) / L::kRows;
  if constexpr (L::kGz) {
    if (gz == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = static_cast<int>(cudaFuncSetAttribute(
        convnext_tail_gz_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SplitGz<C>::kBytes));
    if (err) return err;
    convnext_tail_gz_kernel<C><<<blocks, kBlockThreads, SplitGz<C>::kBytes, stream>>>(
        tw1, static_cast<const float*>(h), static_cast<const float*>(lns),
        static_cast<const float*>(lnb), static_cast<const float*>(b1),
        static_cast<float*>(gz), N, eps);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  err = static_cast<int>(cudaFuncSetAttribute(
      convnext_tail_bwd_kernel<C, 3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (err) return err;
  convnext_tail_bwd_kernel<C, 3><<<blocks, kBlockThreads, L::kBytes, stream>>>(
      th, tdy, tw1, tw2, static_cast<const float*>(h),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const float*>(b1), static_cast<const float*>(gamma),
      static_cast<float*>(dh), N, eps, static_cast<const float*>(dy),
      static_cast<const float*>(gz));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of K3 (bwd 0) or K4 (bwd 1) at width C, bytes, of
// the bf16 kernels (parts 1) or of the fp32 forms (parts 3; bwd 2: K4's z
// pre-pass, C 384), or 0 for another C (for the build report).
extern "C" int convnext_tail_smem(int C, int bwd, int parts) {
  if (parts == 3) {
    switch (C * 4 + bwd) {
      case 96 * 4: return SplitTail<96>::kBytes;
      case 192 * 4: return SplitTail<192>::kBytes;
      case 384 * 4: return SplitTail<384>::kBytes;
      case 96 * 4 + 1: return SplitBwd<96>::kBytes;
      case 192 * 4 + 1: return SplitBwd<192>::kBytes;
      case 384 * 4 + 1: return SplitBwd<384>::kBytes;
      case 384 * 4 + 2: return SplitGz<384>::kBytes;
      default: return 0;
    }
  }
  switch (C) {
    case 96: return bwd ? Tail<96, true>::kBytes : Tail<96, false>::kBytes;
    case 192: return bwd ? Tail<192, true>::kBytes : Tail<192, false>::kBytes;
    case 384: return bwd ? Tail<384, true>::kBytes : Tail<384, false>::kBytes;
    default: return 0;
  }
}

// K3's fp32 form, first pass: w1 (4C, C) and w2 (C, 4C) fp32, contiguous
// and 16-byte aligned, into parts (2, 3, 4C·C) bf16 (see
// split_weights_kernel). C a multiple of 32 (cudaErrorInvalidValue
// otherwise). Returns cudaGetLastError() after the launch.
extern "C" int convnext_tail_split(const void* w1, const void* w2, void* parts,
                                   int C, void* stream) {
  if (C <= 0 || C % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 4 * C * C;
  const dim3 grid((n / 4 + 255) / 256, 2);
  split_weights_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<bf16*>(parts), n);
  return static_cast<int>(cudaGetLastError());
}

// K3's fp32 form: h, x, y (N, C) fp32; lns, lnb, b2, gamma (C,) and b1 (4C,)
// fp32; parts the weights' parts from convnext_tail_split. All contiguous
// and 16-byte aligned. C in {96, 192, 384}. Returns as convnext_tail_fwd.
extern "C" int convnext_tail_f32_fwd(const void* h, const void* x,
                                     const void* lns, const void* lnb,
                                     const void* parts, const void* b1,
                                     const void* b2, const void* gamma, void* y,
                                     int N, int C, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_fwd_parts<96>(h, x, lns, lnb, parts, b1, b2, gamma, y, N, eps, st);
    case 192: return launch_fwd_parts<192>(h, x, lns, lnb, parts, b1, b2, gamma, y, N, eps, st);
    case 384: return launch_fwd_parts<384>(h, x, lns, lnb, parts, b1, b2, gamma, y, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether K4's fp32 form at width C takes the z pre-pass, whose output gz
// (N, 4C) fp32 the caller allocates: 1 or 0.
extern "C" int convnext_tail_f32_bwd_gz(int C) {
  return C == 384 ? SplitBwd<384>::kGz
                  : C == 192 ? SplitBwd<192>::kGz : SplitBwd<96>::kGz;
}

// K4's fp32 form: h, dy, dh (N, C) fp32; lns, lnb, gamma (C,) and b1 (4C,)
// fp32; parts the weights' parts from convnext_tail_split; gz (N, 4C) fp32
// scratch where convnext_tail_f32_bwd_gz(C), else null. All contiguous and
// 16-byte aligned. C in {96, 192, 384}. Returns as convnext_tail_fwd.
extern "C" int convnext_tail_f32_bwd(const void* h, const void* dy,
                                     const void* lns, const void* lnb,
                                     const void* parts, const void* b1,
                                     const void* gamma, void* gz, void* dh,
                                     int N, int C, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return launch_bwd_parts<96>(h, dy, lns, lnb, parts, b1, gamma, gz, dh, N, eps, st);
    case 192: return launch_bwd_parts<192>(h, dy, lns, lnb, parts, b1, gamma, gz, dh, N, eps, st);
    case 384: return launch_bwd_parts<384>(h, dy, lns, lnb, parts, b1, gamma, gz, dh, N, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
