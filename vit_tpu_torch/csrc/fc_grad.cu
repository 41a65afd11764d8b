// K10: a linear layer's weight and bias gradients in one pass over the
// upstream gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernel vit_tpu/kernels/fc_grad.py:_fc_grad_kernel
// (:74, launched by matmul_dw_db :145) behind fused_dense (:237). With the
// port's (out, in) weights, for g (N, F_out) and x (N, F_in):
//   dW = gᵀ · x   (F_out, F_in) fp32,   db = Σₙ g   (F_out) fp32,
// the JAX package's fc2 arrangement, for fc1 and fc2 alike. Rows past N are
// zero-filled in both operands (the Pallas kernel zeroes both for the same
// reason: undefined rows times zeros are not zero).
//
// What bounds it: 2·N·F_out·F_in FLOP against N·(F_out + F_in) bf16 values
// read and F_out·F_in fp32 values written, ≈ 600 FLOP per byte at the
// flagship's 768 × 3072 over N 20480: the tensor cores (0.098 ms at 989
// TFLOP/s). The bf16 form (fc_grad_bf16_kernel) reads its operands in the
// swizzled layout and MN-major, as the fp32 form below reads its parts,
// but straight from TMA: a block owns a 128 × 256 dW tile over its split
// of N; one thread of its producer warpgroup TMA-loads each
// 32-row atom's bf16 boxes of g (128 columns) and x (256) into an 8-stage
// ring; two consumer warpgroups take 64 dW rows each, wgmma m64n256k16
// with gᵀ and x both MN-major (no transposed copy), every atom of the
// split chained in one accumulator. In the blocks of the first F_in
// column two more producer warps sum db from the g tiles in the ring: no
// second pass over g. The output has only 72 such tiles at the flagship's
// shapes for 132 SMs, so N is cut into `splits` parts (the caller's
// kernels/fc_grad.py:splits_bf16, 5 there) whose blocks store their fp32
// partials without waiting for each other; the last block of a tile to
// finish (a count a tile) adds the tile's partials in split order while
// they are still in L2 (store1): deterministic, no float atomics, one
// launch. Measured on an H100 (PERF.md §6): 32-row atoms beat 64-row ones
// and 128 × 256 tiles beat 128 × 128; the last block's sum beat a chain
// of splits each waiting on a flag for the one before and the partials
// added by sum_splits after the kernel; a persistent grid walking the
// tiles was slower; the split count moves it most.
//
// The fp32 form (fc_grad_f32), for fp32 g and x, where the Pallas kernel
// sums its fp32 operands' products at full precision: the same dW and db,
// dW as the TPU's Precision.HIGHEST takes it, six bf16 products of three
// bf16 parts of each operand (hopper.cuh's split products), on wgmma. Both
// operands are read MN-major, as they lie in memory: N, the reduction, is
// the row index of g and of x, so gᵀ and x reach wgmma through the
// transpose bits (wgmma_ss_mn128) and no transposed copy is made. A block
// of four warpgroups owns a 128 × 128 dW tile over its split of N:
//   - one thread of the converter warpgroups TMA-loads each 32-row atom's
//     fp32 tiles of g and x (4 boxes of 32 columns each) into a 4-stage
//     ring, and the two converter warpgroups split them into three bf16
//     parts (x = x0 + x1 + x2 exactly) in swizzled part tiles, two buffers
//     deep, fence.proxy.async before the consumers' products read them;
//   - the two consumer warpgroups take 64 dW rows each, m64n128k16, each
//     atom's six products in a fresh accumulator added to the tile's sum in
//     registers (a sum chained in one accumulator loses low bits at each
//     product, attention_tile.cuh:head_rb_into);
//   - the blocks of the first F_in column sum db from the fp32 g tiles in
//     the converters' registers, never from the parts, in a fixed order.
// Split in the kernel, the parts never reach device memory. Built on an
// H100 and not kept (PERF.md §6): a pre-split pass (472 MB of parts
// written at fc2, 1.5× the fp32 tiles' bytes read from L2), one converter
// warpgroup (clock64 counters showed the consumers waiting on its split),
// one atom's products kept in flight (spilled under setmaxnreg), gᵀ's
// fragments split in the consumers' registers (A from registers, x alone
// through the converter) and a ring in place of the converters' barrier:
// all slower. The block's shared-memory traffic (TMA in, the split's
// reads and writes, the products' operand reads: 256 KB an atom) is the
// likely limit.
// Fixed-order split partials, added by sum_splits; the caller chooses the
// splits so that the 1-block-an-SM grid fills whole waves.
// Bound: 12·N·F_out·F_in FLOP at 989/6 TFLOP/s (0.586 ms at fc2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace vit;

constexpr int kTile = 128;     // dW rows a block (F_out), and columns of the fp32 form
constexpr int kSumThreads = 256;

// ---- the fp32 form: split bf16 products on wgmma --------------------------

namespace split {

using namespace vit::hopper;

constexpr int kAtom = 32;                    // rows of N an atom
constexpr int kConsumers = 256;              // two warpgroups, 64 dW rows each
constexpr int kConverters = 256;             // two warpgroups
constexpr int kThreads = kConsumers + kConverters;
constexpr int kBox = kAtom * 128;            // an atom's 128-byte-wide box
constexpr int kF32Stage = 2 * 4 * kBox;      // g's, then x's 128 fp32 columns
constexpr int kF32Stages = 4;

// The shared memory: a ring of fp32 stages (each 4 TMA boxes of 32 columns
// of g, then of x), two buffers of bf16 parts ([operand g, x][part][64-col
// atom][32 rows][128 B], the 128-byte swizzle), the barriers.
template <int kParts>
struct Plan {
  static constexpr int kPart = 2 * kBox;           // one part of 128 columns
  static constexpr int kOperand = kParts * kPart;
  static constexpr int kBuf = 2 * kOperand;
  static constexpr int kBufs = kF32Stages * kF32Stage;  // offset of the buffers
  static constexpr int kBars = kBufs + 2 * kBuf;
  static constexpr int kBytes = kBars + 256 + 1024;
};

struct Bars {
  uint64_t f32[kF32Stages];  // an fp32 stage landed (TMA bytes)
  uint64_t full[2];          // a parts buffer written (every converter thread)
  uint64_t empty[2];         // a parts buffer read (8 consumer warps)
};

// An atom's fp32 boxes: g's columns m0 .. m0 + 127 and x's c0 .. c0 + 127
// of rows n0 .. n0 + 31 (zeros past N), into stage st.
__device__ __forceinline__ void load_atom(uint8_t* sm, Bars& bars,
                                          const CUtensorMap* tg,
                                          const CUtensorMap* tx, int st,
                                          int m0, int c0, int n0) {
  uint8_t* dst = sm + st * kF32Stage;
  mbar_arrive_expect_tx(&bars.f32[st], kF32Stage);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    tma_load_2d(dst + b * kBox, tg, &bars.f32[st], m0 + 32 * b, n0);
    tma_load_2d(dst + (4 + b) * kBox, tx, &bars.f32[st], c0 + 32 * b, n0);
  }
}

// The converter warpgroups: each atom's fp32 tiles from the ring into
// kParts bf16 parts in buffer a % 2 (x = x0 + x1 + x2 exactly, as
// hopper.cuh:put_a splits), as soon as the consumers are done with that
// buffer's last atom. Thread ct takes 4 columns (4·(ct % 32) ..) of the
// rows ct / 32 + 8k of both operands; its thread 0 loads stage a % 4
// again for atom a + 4 once every converter has read it. The blocks of the
// first F_in column also sum db from the fp32 g in registers: each thread
// its 4 columns over its rows in order, then the eight threads of a column
// in order.
template <int kParts>
__device__ __forceinline__ void convert(uint8_t* sm, Bars& bars,
                                        const CUtensorMap* tg,
                                        const CUtensorMap* tx, int m0, int c0,
                                        int n_begin, int atoms, bool with_db,
                                        float* db) {
  using P = Plan<kParts>;
  constexpr int kSets = kConverters / 32;  // row sets: rows ≡ set (mod kSets)
  const int ct = threadIdx.x - kConsumers, cc = ct % 32, rr0 = ct / 32;
  if (ct == 0)
    for (int a = 0; a < atoms && a < kF32Stages; ++a)
      load_atom(sm, bars, tg, tx, a, m0, c0, n_begin + kAtom * a);
  float dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int col = 4 * cc;
  const int src_off = (cc / 8) * kBox, dst_off = (col / 64) * kBox + (col % 8) * 2;
  for (int a = 0; a < atoms; ++a) {
    const int st = a % kF32Stages, buf = a % 2;
    mbar_wait(&bars.f32[st], (a / kF32Stages) & 1);
    if (a >= 2) mbar_wait(&bars.empty[buf], ((a - 2) / 2) & 1);
    const uint8_t* src = sm + st * kF32Stage;
    uint8_t* dst = sm + P::kBufs + buf * P::kBuf;
#pragma unroll
    for (int op = 0; op < 2; ++op)
#pragma unroll
      for (int k = 0; k < kAtom / kSets; ++k) {
        const int rr = rr0 + kSets * k;
        const float4 f = *reinterpret_cast<const float4*>(
            src + op * 4 * kBox + src_off + rr * 128 + (((cc % 8) ^ (rr % 8)) << 4));
        float v[4] = {f.x, f.y, f.z, f.w};
        if (op == 0 && with_db)
#pragma unroll
          for (int i = 0; i < 4; ++i) dbacc[i] += v[i];
        uint8_t* o = dst + op * P::kOperand + dst_off + rr * 128 +
                     ((((col % 64) / 8) ^ (rr % 8)) << 4);
        store_parts<kParts>(v, reinterpret_cast<__nv_bfloat16*>(o), P::kPart / 2);
      }
    fence_proxy_async();
    mbar_arrive(&bars.full[buf]);
    named_barrier(2, kConverters);  // every converter is done with stage st
    if (ct == 0 && a + kF32Stages < atoms)
      load_atom(sm, bars, tg, tx, st, m0, c0, n_begin + kAtom * (a + kF32Stages));
  }
  if (with_db) {  // the fp32 stages are free: the row sets of a column
    float* s = reinterpret_cast<float*>(sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[rr0 * 128 + col + i] = dbacc[i];
    named_barrier(2, kConverters);
    if (ct < 128) {
      float v = s[ct];
#pragma unroll
      for (int k = 1; k < kSets; ++k) v += s[k * 128 + ct];
      db[m0 + ct] = v;
    }
  }
}

// A consumer warpgroup: dW rows m0 + 64·wg .. + 63, all 128 columns, over
// the block's atoms: each atom's kParts-part product (six bf16 products,
// small terms first: hopper.cuh's split_a/split_b) in a fresh accumulator,
// then added to the sum in registers; then the tile into out.
template <int kParts>
__device__ __forceinline__ void consume(uint8_t* sm, Bars& bars, float* out,
                                        int Fi, int m0, int c0, int atoms) {
  using P = Plan<kParts>;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  const uint32_t bufs = smem_u32(sm + P::kBufs);
  for (int a = 0; a < atoms; ++a) {
    const int buf = a % 2;
    mbar_wait(&bars.full[buf], (a / 2) & 1);
    const uint32_t gp = opaque(bufs + buf * P::kBuf) + wg * kBox;  // gᵀ's 64 rows
    const uint32_t xp = opaque(bufs + buf * P::kBuf) + P::kOperand;
    float f[64];
    wgmma_fence();
#pragma unroll
    for (int tm = kFirstTerm<kParts>; tm < 6; ++tm)
#pragma unroll
      for (int ks = 0; ks < kAtom / 16; ++ks)
        wgmma_ss_mn128(f, desc_mn(gp + split_a(tm) * P::kPart + 2048 * ks),
                       desc_mn2(xp + split_b(tm) * P::kPart + 2048 * ks, kBox),
                       tm > kFirstTerm<kParts> || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&bars.empty[buf]);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * r;
      const int col = c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * Fi + col) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// ---- the bf16 form: the fp32 form's layouts at one part ------------------
//
// bf16 g and x need no split: one thread TMA-loads each atom's bf16 boxes
// (64 columns x kAtom1 rows, the 128-byte swizzle) straight into the
// [64-col atom][rows][128 B] layout the converters above write for a part,
// and the consumers read them MN-major as they read a part. The ring holds
// g's 128 columns and x's kBN1 an atom; a one-term product needs no fresh
// accumulator, so each consumer warpgroup chains every atom of its split
// into one accumulator (dW reads 4.4e-6 of the plain product's mean on an
// H100, K10_DW_MEAN_REL 5.57e-5), keeping the latest atom's products in
// flight while it frees the stage before. kDbWarps more warps of the
// producer warpgroup sum db from the same g tiles in the blocks of the
// first F_in column, and free each stage beside the consumers: no second
// pass over g.
constexpr int kAtom1 = 32;          // rows of N a ring stage: 2 k16 steps
constexpr int kBN1 = 256;           // dW columns a block (m64n256)
static_assert(kBN1 == 256, "consume1 issues m64n256k16");
constexpr int kDbWarps = 2;         // producer warps that sum db
constexpr int kProducers = 128;     // the producer warpgroup
constexpr int kDbSets = 2 * kDbWarps;  // db's row sets: a half warp each

struct Plan1 {
  static constexpr int kBox = kAtom1 * 128;             // one 64-column box
  static constexpr int kStage = (2 + kBN1 / 64) * kBox;  // g's 2 boxes, x's
  static constexpr int kStages = 196608 / kStage;
  static constexpr int kSets = kStages * kStage;  // [kDbSets][128] fp32
  static constexpr int kDb = kSets + kDbSets * 128 * 4;  // the block's db
  static constexpr int kLast = kDb + 128 * 4;  // int: the tile's last split
  static constexpr int kRing = kLast + 16;
  static constexpr int kBytes = kRing + sizeof(Ring<kStages>) + 1024;
};
using Ring1 = Ring<Plan1::kStages>;

// A block's work in the bf16 form: dW rows m0 .. m0 + 127 (blockIdx.y),
// columns c0 .. c0 + kBN1 − 1 (blockIdx.x), over split blockIdx.z of N.
struct Unit {
  int m0, c0, n_begin, atoms, split, tile;
  bool with_db;  // the first F_in column sums db
  __device__ Unit(int N, int rows_per_split) {
    split = blockIdx.z;
    tile = blockIdx.y * gridDim.x + blockIdx.x;
    c0 = blockIdx.x * kBN1;
    m0 = blockIdx.y * kTile;
    with_db = blockIdx.x == 0;
    n_begin = split * rows_per_split;
    const int n_end = min(N, n_begin + rows_per_split);
    atoms = n_end > n_begin ? (n_end - n_begin + kAtom1 - 1) / kAtom1 : 0;
  }
};

// The producer thread: the unit's atoms (g's columns m0 .. m0 + 127, x's
// c0 .. c0 + kBN1 − 1 of rows n_begin + kAtom1·a ..; zeros past N and
// past F_in) into stage a % kStages once every reader has freed it.
__device__ __forceinline__ void produce1(uint8_t* sm, Ring1& ring,
                                         const CUtensorMap* tg,
                                         const CUtensorMap* tx,
                                         const Unit& w) {
  for (int a = 0; a < w.atoms; ++a) {
    ring.wait_empty(a);
    const int st = Ring1::stage(a), n0 = w.n_begin + kAtom1 * a;
    uint8_t* dst = sm + st * Plan1::kStage;
    uint64_t* bar = &ring.full[st];
    mbar_arrive_expect_tx(bar, Plan1::kStage);
    tma_load_2d(dst, tg, bar, w.m0, n0);
    tma_load_2d(dst + Plan1::kBox, tg, bar, w.m0 + 64, n0);
#pragma unroll
    for (int b = 0; b < kBN1 / 64; ++b)
      tma_load_2d(dst + (2 + b) * Plan1::kBox, tx, bar, w.c0 + 64 * b, n0);
  }
}

// A db warp w (0 .. kDbWarps − 1) of a block of the first F_in column:
// each half warp sums row set 2w + h (rows ≡ set mod kDbSets of every
// atom, in order), 8 columns a lane (8·(lane % 16) ..: one 16-byte chunk
// of a swizzled row), in fp32, freeing each stage beside the consumers;
// then the sets of a column in order into out[128] (shared memory).
__device__ __forceinline__ void sum_db1(uint8_t* sm, Ring1& ring, int atoms,
                                        int w, float* out) {
  const int lane = threadIdx.x % 32, set = 2 * w + lane / 16;
  const int col = 8 * (lane % 16), chunk = (col % 64) / 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int a = 0; a < atoms; ++a) {
    ring.wait_full(a);
    const uint8_t* src =
        sm + Ring1::stage(a) * Plan1::kStage + (col / 64) * Plan1::kBox;
#pragma unroll
    for (int k = 0; k < kAtom1 / kDbSets; ++k) {
      const int r = kDbSets * k + set;
      const uint4 v = *reinterpret_cast<const uint4*>(
          src + r * 128 + ((chunk ^ (r % 8)) << 4));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * i] += __uint_as_float(u[i] << 16);
        acc[2 * i + 1] += __uint_as_float(u[i] & 0xFFFF0000u);
      }
    }
    ring.release(a);
  }
  float* sets = reinterpret_cast<float*>(sm + Plan1::kSets);
#pragma unroll
  for (int i = 0; i < 8; ++i) sets[set * 128 + col + i] = acc[i];
  named_barrier(3, 32 * kDbWarps);
  for (int c = threadIdx.x % (32 * kDbWarps); c < 128; c += 32 * kDbWarps) {
    float v = sets[c];
#pragma unroll
    for (int k = 1; k < kDbSets; ++k) v += sets[k * 128 + c];
    out[c] = v;
  }
}

// A consumer warpgroup: dW rows m0 + 64·wg .. + 63, kBN1 columns, every
// atom of the unit chained into acc (m64n256k16, gᵀ and x MN-major).
__device__ __forceinline__ void consume1(uint8_t* sm, Ring1& ring, int atoms,
                                         float (&acc)[kBN1 / 2]) {
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int e = 0; e < kBN1 / 2; ++e) acc[e] = 0.0f;
  for (int a = 0; a < atoms; ++a) {
    ring.wait_full(a);
    const uint32_t st = opaque(smem_u32(sm + Ring1::stage(a) * Plan1::kStage));
    const uint32_t gp = st + wg * Plan1::kBox, xp = st + 2 * Plan1::kBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kAtom1 / 16; ++ks)
      wgmma_ss_mn256(acc, desc_mn(gp + 2048 * ks),
                     desc_mn2(xp + 2048 * ks, Plan1::kBox), 1);
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // atom a − 1's products are done: free its stage
    if (a > 0) ring.release(a - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (atoms > 0) ring.release(atoms - 1);
}

// The consumers' epilogue: the split's dW tile (and, from the first F_in
// column, the block's db in dbs). One split writes them into dw and db as
// they are. More splits write their partials at part + s·Fo·Fi and
// part_db + s·Fo without waiting for each other; with a count a tile
// (counts), the last block of a tile to arrive then adds the tile's
// partials into dw and db in split order, (((p0 + p1) + p2) + ...), read
// through L2 while they are still there, and sets the count back to zero
// for the next call: a fixed order, no float atomics, no second pass.
__device__ __forceinline__ void store1(const float (&acc)[kBN1 / 2], float* dw,
                                       float* db, float* part, float* part_db,
                                       const float* dbs, int* counts,
                                       int* last, const Unit& w, int splits,
                                       int Fo, int Fi) {
  const int s = w.split, wg = threadIdx.x / 128, m0 = w.m0, c0 = w.c0;
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  float* out = splits > 1 ? part + static_cast<size_t>(s) * Fo * Fi : dw;
  float* out_db = splits > 1 ? part_db + static_cast<size_t>(s) * Fo : db;
  named_barrier(1, kConsumers + (w.with_db ? 32 * kDbWarps : 0));  // dbs
  float* row = out + static_cast<size_t>(m0 + 64 * wg + 16 * warp + g) * Fi;
#pragma unroll
  for (int j = 0; j < kBN1 / 8; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= Fi) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(row + static_cast<size_t>(8 * r) * Fi + col) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  if (w.with_db && threadIdx.x < 128) out_db[m0 + threadIdx.x] = dbs[threadIdx.x];
  if (splits == 1) return;
  __threadfence();  // this block's partials before its count
  named_barrier(2, kConsumers);
  if (threadIdx.x == 0) *last = atomicAdd(counts + w.tile, 1) == splits - 1;
  named_barrier(2, kConsumers);
  if (!*last) return;
  __threadfence();
  // The tile's partials, float4 by float4 (thread i takes i + 256·k, 16 at
  // a time), summed over the splits in order.
  constexpr int kCols4 = kBN1 / 4, kPer = kTile * kCols4 / kConsumers;
  constexpr int kHalf = 16;
#pragma unroll 1
  for (int h = 0; h < kPer; h += kHalf) {
    float4 sum[kHalf];
#pragma unroll 1
    for (int sp = 0; sp < splits; ++sp) {
      const float* src = part + static_cast<size_t>(sp) * Fo * Fi;
      float4 v[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int idx = threadIdx.x + kConsumers * (h + i);
        const int c = c0 + 4 * (idx % kCols4);
        v[i] = c < Fi ? __ldcg(reinterpret_cast<const float4*>(
                            src + static_cast<size_t>(m0 + idx / kCols4) * Fi + c))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        sum[i] = sp == 0 ? v[i]
                         : make_float4(sum[i].x + v[i].x, sum[i].y + v[i].y,
                                       sum[i].z + v[i].z, sum[i].w + v[i].w);
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int idx = threadIdx.x + kConsumers * (h + i);
      const int c = c0 + 4 * (idx % kCols4);
      if (c < Fi)
        *reinterpret_cast<float4*>(dw + static_cast<size_t>(m0 + idx / kCols4) * Fi + c) =
            sum[i];
    }
  }
  if (w.with_db && threadIdx.x < 128) {
    float v = __ldcg(part_db + m0 + threadIdx.x);
    for (int sp = 1; sp < splits; ++sp)
      v += __ldcg(part_db + static_cast<size_t>(sp) * Fo + m0 + threadIdx.x);
    db[m0 + threadIdx.x] = v;
  }
  if (threadIdx.x == 0) counts[w.tile] = 0;  // zero for the next call
}

// K10's fp32 form on g (tg) and x (tx): a block a 128 x 128 dW tile
// (blockIdx.x the F_in tile, .y the F_out tile) over split blockIdx.z of
// N. Writes the split's dW partial (dw + split·Fo·Fi) and, from the first
// F_in column, its db partial (db + split·Fo).
template <int kParts>
__global__ void __launch_bounds__(kThreads, 1)
fc_grad_split_kernel(const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tx,
                     float* __restrict__ dw, float* __restrict__ db, int N,
                     int Fo, int Fi, int rows_per_split) {
  uint8_t* sm = &aligned_smem<uint8_t>();
  Bars& bars = *reinterpret_cast<Bars*>(sm + Plan<kParts>::kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) mbar_init(&bars.f32[s], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bars.full[b], kConverters);
      mbar_init(&bars.empty[b], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int c0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int atoms = n_end > n_begin ? (n_end - n_begin + kAtom - 1) / kAtom : 0;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<88>();
    convert<kParts>(sm, bars, &tg, &tx, m0, c0, n_begin, atoms, blockIdx.x == 0,
                    db + static_cast<size_t>(blockIdx.z) * Fo);
  } else {
    setmaxnreg_inc<168>();
    consume<kParts>(sm, bars, dw + static_cast<size_t>(blockIdx.z) * Fo * Fi, Fi,
                    m0, c0, atoms);
  }
}

// K10's bf16 form on g (tg) and x (tx): a block a 128 x kBN1 dW tile
// (blockIdx.x the F_in tile, .y the F_out tile) over split blockIdx.z of
// N, stored through store1 (dw and db, or part, part_db and counts).
__global__ void __launch_bounds__(kConsumers + kProducers, 1)
fc_grad_bf16_kernel(const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tx,
                    float* __restrict__ dw, float* __restrict__ db, float* part,
                    float* part_db, int* counts, int N, int Fo, int Fi,
                    int rows_per_split, int splits) {
  uint8_t* sm = &aligned_smem<uint8_t>();
  Ring1& ring = *reinterpret_cast<Ring1*>(sm + Plan1::kRing);
  const Unit w(N, rows_per_split);
  if (threadIdx.x == 0) {
    ring.init(1, kConsumers / 32 + (w.with_db ? kDbWarps : 0));
    mbar_init_fence();
  }
  __syncthreads();
  float* dbs = reinterpret_cast<float*>(sm + Plan1::kDb);
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<40>();
    const int pw = (threadIdx.x - kConsumers) / 32;
    if (pw == 0) {
      if (threadIdx.x % 32 == 0) produce1(sm, ring, &tg, &tx, w);
    } else if (w.with_db && pw <= kDbWarps) {
      sum_db1(sm, ring, w.atoms, pw - 1, dbs);
      named_barrier(1, kConsumers + 32 * kDbWarps);  // dbs written
    }
  } else {
    setmaxnreg_inc<232>();
    float acc[kBN1 / 2];
    consume1(sm, ring, w.atoms, acc);
    store1(acc, dw, db, part, part_db, dbs, counts,
           reinterpret_cast<int*>(sm + Plan1::kLast), w, splits, Fo, Fi);
  }
}

}  // namespace split

// out[i] = Σ_s part[s][i] over `splits` partials of n floats, s in order.
__global__ void __launch_bounds__(kSumThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * kSumThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kSumThreads) + threadIdx.x;
       i < n / 4; i += stride) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = reinterpret_cast<const float4*>(part + k * n)[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
}

int sum_splits(const float* part, float* out, long long n, int splits,
               cudaStream_t stream) {
  long long blocks = (n / 4 + kSumThreads - 1) / kSumThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(
      part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dW tiles of the bf16 form (its counts a call): the blocks of a split.
extern "C" int fc_grad_tiles(int Fo, int Fi) {
  return (Fo / kTile) * ((Fi + split::kBN1 - 1) / split::kBN1);
}

// g (N, Fo), x (N, Fi): bf16, contiguous, 16-byte aligned; Fo and Fi
// multiples of 128 (cudaErrorInvalidValue otherwise). dw (Fo, Fi) and db
// (Fo) fp32. With splits > 1, part (splits, Fo, Fi) and part_db (splits,
// Fo) fp32 scratch take the partials, and counts, an int (zero) a dW tile,
// fc_grad_tiles(Fo, Fi) of them, let the last block of each tile add them
// in order inside the kernel (which leaves the counts zero). Returns
// cudaGetLastError() after the launch or the error of building a tensor
// map.
extern "C" int fc_grad(const void* g, const void* x, void* dw, void* db,
                       void* part, void* part_db, void* counts, int N, int Fo,
                       int Fi, int splits, void* stream) {
  if (Fo % kTile || Fi % kTile || Fo <= 0 || Fi <= 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || part_db == nullptr || counts == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  using P = split::Plan1;
  CUtensorMap tg, tx;
  int e = hopper::matrix_map(&tg, g, N, Fo, 2, split::kAtom1);
  if (!e) e = hopper::matrix_map(&tx, x, N, Fi, 2, split::kAtom1);
  if (!e)
    e = static_cast<int>(cudaFuncSetAttribute(
        split::fc_grad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::kBytes));
  if (e) return e;
  const int atoms = (N + split::kAtom1 - 1) / split::kAtom1;
  const int rows_per_split = ((atoms + splits - 1) / splits) * split::kAtom1;
  split::fc_grad_bf16_kernel
      <<<dim3((Fi + split::kBN1 - 1) / split::kBN1, Fo / kTile, splits),
         split::kConsumers + split::kProducers, P::kBytes,
         static_cast<cudaStream_t>(stream)>>>(
          tg, tx, static_cast<float*>(dw), static_cast<float*>(db),
          static_cast<float*>(part), static_cast<float*>(part_db),
          static_cast<int*>(counts), N, Fo, Fi, rows_per_split, splits);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 form: g (N, Fo), x (N, Fi) fp32, contiguous, 16-byte aligned;
// the rest as for fc_grad, rows_per_split a multiple of 32. Returns
// cudaGetLastError() after the launches or the error of building a tensor
// map.
extern "C" int fc_grad_f32(const void* g, const void* x, void* dw, void* db,
                           void* part, void* part_db, int N, int Fo, int Fi,
                           int splits, void* stream) {
  if (Fo % kTile || Fi % kTile || Fo <= 0 || Fi <= 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || part_db == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  using P = split::Plan<3>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tg, tx;
  int e = hopper::matrix_map(&tg, g, N, Fo, 4, split::kAtom);
  if (!e) e = hopper::matrix_map(&tx, x, N, Fi, 4, split::kAtom);
  if (!e)
    e = static_cast<int>(cudaFuncSetAttribute(
        split::fc_grad_split_kernel<3>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes));
  if (e) return e;
  const int atoms = (N + split::kAtom - 1) / split::kAtom;
  const int rows_per_split = ((atoms + splits - 1) / splits) * split::kAtom;
  float* dw_out = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  float* db_out = splits > 1 ? static_cast<float*>(part_db) : static_cast<float*>(db);
  split::fc_grad_split_kernel<3>
      <<<dim3(Fi / kTile, Fo / kTile, splits), split::kThreads, P::kBytes, st>>>(
          tg, tx, dw_out, db_out, N, Fo, Fi, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  e = sum_splits(static_cast<const float*>(part), static_cast<float*>(dw),
                 static_cast<long long>(Fo) * Fi, splits, st);
  if (e) return e;
  return sum_splits(static_cast<const float*>(part_db), static_cast<float*>(db),
                    Fo, splits, st);
}

// K10's dynamic shared memory, bytes (for the build report): the fp32
// form's (f32 1) or the bf16 form's.
extern "C" int fc_grad_smem(int f32) {
  return f32 ? split::Plan<3>::kBytes : split::Plan1::kBytes;
}
